"""2D registration + segmentation engines (L2).

Two engines, matching the reference's two segmentation families:

* ``segment_ecoli``: KMeans foreground + iterative-erosion seeding +
  watershed on the log-sum image — the E. coli / reference-measurement path
  (hiprfish_imaging_spectral_image_measurement.py:44-127).

* ``segment_lpcv``: NL-means denoise + fused LP-CV line-profile enhancement +
  KMeans + morphology seeding + watershed on the enhanced image — the
  synthetic-community / biofilm path
  (hiprfish_imaging_multispecies_spectral_image_measurement.py:78-159,
  hiprfish_imaging_biofilm_analysis.py:322-419).

Execution model: each stage kernel (FFT registration, fused LP-CV, KMeans,
CCL, watershed, segment_sum props) is its own jitted XLA program; the engine
orchestrates them from the host while all arrays stay device-resident. This
bounds per-program compile time while keeping zero host<->device traffic
between stages. (A fully fused single-program variant of the LP-CV hot path
is exposed separately for the benchmark entry point.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from hiprfish_tpu.config import SegmentationConfig
from hiprfish_tpu.ops import denoise as dn
from hiprfish_tpu.ops import kmeans as km
from hiprfish_tpu.ops import labeling as lab
from hiprfish_tpu.ops import line_profile as lp
from hiprfish_tpu.ops import morphology as morph
from hiprfish_tpu.ops import regionprops as rp
from hiprfish_tpu.ops import register as reg
from hiprfish_tpu.ops import watershed as ws


class Segmentation2D(NamedTuple):
    """Device-side result of a 2D segmentation."""

    segmentation: jax.Array        # (H, W) int32, sequential labels 1..n
    n_cells: jax.Array             # scalar int32
    registered: jax.Array          # (H, W, C) registered (uncorrected) image
    fov_sum: jax.Array             # (H, W) registered channel sum
    enhanced: jax.Array            # (H, W) surface used for flooding
    adjacency: jax.Array           # (H, W) int32 adjacency segmentation (or 0s)
    epithelial: jax.Array          # (H, W) bool epithelial/debris area (or 0s)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _register_stack(image_stack, projections, max_shift, clamp, log_domain=False):
    """Register per-laser images to laser 0 on their projections and
    concatenate channels. Returns (registered (H,W,C), overlap_mask (H,W))."""
    if log_domain:
        projections = [jnp.log(p + 1e-8) for p in projections]
    ref = projections[0]
    parts = []
    overlap = jnp.ones(ref.shape, bool)
    for i, img in enumerate(image_stack):
        if i == 0:
            parts.append(img)
            continue
        s = reg.register_translation(ref, projections[i])
        if clamp:
            s = reg.clamp_shift(s, max_shift)
        shifted, mask = reg.apply_shift_2d(img, s)
        parts.append(shifted)
        overlap = overlap & mask
    return jnp.concatenate(parts, axis=2), overlap


@jax.jit
def _erode_labels_twice(labels):
    """Per-region double erosion of a label image: a pixel survives iff its
    whole cross-neighborhood carries the same label (equivalent to eroding
    every region against its own complement, as the reference does per cell
    image, spectral_image_measurement.py:122)."""
    out = labels
    for _ in range(2):
        cur = out
        for off in morph._cross_shifts(labels.ndim):
            nb = lab.shifted(cur, off, -1)
            same = (nb == cur) | (nb == -1)
            out = jnp.where(same, out, 0)
        out = jnp.where(cur > 0, out, 0)
    return out


@jax.jit
def _component_small_mask(mask, threshold: jax.Array):
    """(small_components, component_labels) of a boolean mask."""
    lbl = lab.label(mask, 2)
    size = mask.size
    flat = jnp.clip(lbl.reshape(-1), 0, size)
    counts = jnp.zeros((size + 1,), jnp.int32).at[flat].add(1)
    small = mask & (counts[flat].reshape(mask.shape) < threshold)
    return small, lbl


def erosion_seed_markers(cell_sm, cfg: SegmentationConfig):
    """Iterative erosion seeding (spectral_image_measurement.py:101-113):
    components below seed_area_max become watershed seeds, the rest are
    eroded and re-examined until the mask is exhausted. Returns sequential
    int32 markers.

    The per-round sub-``seed_min_size`` removal runs at connectivity=1
    (skimage's remove_small_objects default), and that is load-bearing:
    the round's removal deletes diagonal-only bridge fragments between the
    lobes of a touching cell pair, which is what lets the next round's
    8-connected component pass see the lobes separately and seed them
    individually. With 8-connected removal the bridge survives, the pair
    shrinks below seed_area_max as ONE component, and the two cells merge
    into a single watershed basin (diagnosed via DIAG_PARITY_10B.json: all
    10 round-3 10-bit parity disagreements were exactly such merged
    doublets)."""
    mask = cell_sm
    seeds = jnp.zeros_like(cell_sm)
    thr = jnp.int32(cfg.seed_area_max)
    for _ in range(cfg.max_erosion_iters):
        if not bool(jnp.any(mask)):
            break
        small, _ = _component_small_mask(mask, thr)
        seeds = seeds | small
        remaining = mask & ~small
        eroded = morph.binary_erosion(remaining)
        mask = lab.remove_small_objects(eroded, cfg.seed_min_size, 1)

    # The final sub-seed_min_size filter acts on the 8-connected components
    # of the accumulated seed mask (the reference removes whole labels of an
    # 8-connected labeling, spectral_image_measurement.py:111-112).
    seed_mask = lab.remove_small_objects(seeds, cfg.seed_min_size, 2)
    markers, _ = lab.relabel_sequential(
        lab.label(seed_mask, 2, cfg.ccl_max_iters))
    return markers


# ---------------------------------------------------------------------------
# E. coli engine
# ---------------------------------------------------------------------------


def segment_ecoli(
    image_stack,
    cfg: SegmentationConfig = SegmentationConfig(),
    max_cells: int = 4096,
) -> Segmentation2D:
    """Erosion-seeded watershed segmentation of a multi-laser FOV.

    Args:
      image_stack: sequence of per-laser (H, W, C_l) arrays.
      cfg: segmentation parameters.
      max_cells: static bound on the number of cells.

    Pipeline parity (spectral_image_measurement.py:44-127): register on
    per-laser max projections (shift clamp ±15) -> overlap mask -> log-sum ->
    KMeans(2) foreground -> KMeans(3) brightest layer = cell interior ->
    fill small holes + opening + remove_small(50) -> iterative erosion
    seeding (area < 600 becomes a seed) -> watershed(-logsum) ->
    remove_small(100) + clear_border + minor-axis gate [15, 35] with per-cell
    double erosion -> sequential labels.
    """
    image_stack = tuple(jnp.asarray(a) for a in image_stack)
    projections = [jnp.max(img, axis=2) for img in image_stack]
    registered, overlap = _register_stack(
        image_stack, projections, cfg.max_shift, cfg.clamp_shift
    )
    registered = registered * overlap[:, :, None]
    fov_sum = jnp.sum(registered, axis=2)
    image_cn = jnp.log(fov_sum + 1e-2)

    fg, interior = km.brightest_cluster_masks(image_cn, (2, 3),
                                             cfg.kmeans_iters)
    interior = morph.remove_small_holes(interior, 64)
    interior = morph.binary_opening(interior)
    # connectivity=1: skimage's remove_small_objects default, which the
    # reference relies on throughout (spectral_image_measurement.py:98).
    cell_sm = lab.remove_small_objects(interior, 50, 1)

    markers = erosion_seed_markers(cell_sm, cfg)

    seg = ws.watershed(-image_cn, markers, fg, 1, cfg.watershed_max_iters)
    seg = lab.remove_small_labels(seg, cfg.cell_min_size)
    seg = lab.clear_border(seg)
    seg, _ = lab.relabel_sequential(seg)

    props = rp.shape_props_2d(seg, max_cells)
    minor = props["minor_axis_length"]
    keep = (
        (minor >= cfg.minor_axis_min)
        & (minor <= cfg.minor_axis_max)
        & (props["area"] > 0)
    )
    keep = keep.at[0].set(False)
    eroded = _erode_labels_twice(seg)
    kept = jnp.where(keep[jnp.clip(eroded, 0, max_cells - 1)], eroded, 0)
    seg_final, n_cells = lab.relabel_sequential(kept)

    zero_i = jnp.zeros_like(seg_final)
    return Segmentation2D(
        segmentation=seg_final,
        n_cells=n_cells,
        registered=registered,
        fov_sum=fov_sum,
        enhanced=image_cn,
        adjacency=zero_i,
        epithelial=zero_i.astype(bool),
    )


# ---------------------------------------------------------------------------
# LP-CV engine (synthetic-community / biofilm)
# ---------------------------------------------------------------------------


def segment_lpcv(
    image_stack,
    calibration=None,
    cfg: SegmentationConfig = SegmentationConfig(),
    max_cells: int = 4096,
    variant: str = "multispecies",
) -> Segmentation2D:
    """LP-CV enhanced watershed segmentation of a multi-laser FOV.

    variant='multispecies' floods the LP-CV enhanced image within the
    enhancement foreground (multispecies_spectral_image_measurement.py:110-157).
    variant='biofilm' registers in the log domain, floods the denoised sum,
    computes the adjacency segmentation over the full background-filtered
    area and detects the epithelial region (biofilm_analysis.py:322-419).
    """
    biofilm = variant == "biofilm"
    image_stack = tuple(jnp.asarray(a) for a in image_stack)
    projections = [jnp.sum(img, axis=2) for img in image_stack]
    registered, _ = _register_stack(
        image_stack, projections, cfg.max_shift, clamp=False, log_domain=biofilm
    )
    if calibration is not None:
        registered = registered / jnp.asarray(calibration)
    return segment_lpcv_from_registered(registered, cfg, max_cells, variant)


def segment_lpcv_from_registered(
    registered,
    cfg: SegmentationConfig = SegmentationConfig(),
    max_cells: int = 4096,
    variant: str = "multispecies",
) -> Segmentation2D:
    """LP-CV segmentation of an already-registered (H, W, C) image (used by
    the z-slice biofilm path, biofilm_analysis.py:721-776, where the stack is
    pre-registered at load time)."""
    biofilm = variant == "biofilm"
    registered = jnp.asarray(registered)
    fov_sum = jnp.sum(registered, axis=2)
    sum_norm = fov_sum / jnp.maximum(jnp.max(fov_sum), 1e-12)
    denoised = dn.denoise_nl_means_auto(
        sum_norm, cfg.nlm_h, cfg.nlm_patch_size, cfg.nlm_patch_distance
    )

    enhanced = lp.lp_cv_enhance_2d(denoised, cfg.patch_size, cfg.phi_range)

    bkg_src = jnp.log10(denoised + 1e-8) if biofilm else denoised
    bkg = km.brightest_cluster_mask(bkg_src, 2, cfg.kmeans_iters)

    # The enhancement foreground is speckle-heavy outside cells (LP-CV
    # amplifies normalized noise); every seed/flood mask is intersected with
    # the intensity background filter downstream anyway
    # (multispecies...py:152-154), so intersect *first* — identical cell
    # seeds, but the CCL/fill passes run on compact blobs instead of a
    # near-percolation maze (several times fewer propagation rounds).
    fg = km.brightest_cluster_mask(enhanced, 2, cfg.kmeans_iters) & bkg
    # fill(core) & fill(fg) == fill(core): core = filtered opening of fg
    # is a subset of fg, so every core hole is an fg hole (reachability
    # through ~fg implies it through the superset ~core) — the second
    # border flood was a no-op
    seed_mask = morph.binary_fill_holes(
        lab.remove_small_objects(morph.binary_opening(fg), cfg.lp_seed_min_size, 1)
    )

    if biofilm:
        watershed_surface = -(denoised * bkg)
        seed_mask = lab.remove_small_objects(seed_mask & bkg, cfg.lp_seed_min_size, 1)
        flood_mask = fg & bkg
    else:
        watershed_surface = -(enhanced * bkg)
        flood_mask = fg & bkg

    markers_all = lab.label(seed_mask, 2, cfg.ccl_max_iters)
    markers_all, _ = lab.relabel_sequential(markers_all)
    markers = markers_all * bkg.astype(jnp.int32)

    seg = ws.watershed(watershed_surface, markers, flood_mask, 1,
                       cfg.watershed_max_iters)
    if not biofilm:
        seg, n_cells = lab.filter_and_relabel(seg, cfg.lp_cell_min_size)
    else:
        seg, n_cells = lab.relabel_sequential(seg)

    if biofilm:
        adjacency = ws.watershed(-(fov_sum * bkg), markers, bkg, 1,
                                 cfg.watershed_max_iters)
        adjacency, _ = lab.relabel_sequential(adjacency)
        epithelial = _epithelial_area(bkg, fov_sum, cfg)
    else:
        adjacency = jnp.zeros_like(seg)
        epithelial = jnp.zeros(seg.shape, bool)

    return Segmentation2D(
        segmentation=seg,
        n_cells=n_cells,
        registered=registered,
        fov_sum=fov_sum,
        enhanced=enhanced,
        adjacency=adjacency,
        epithelial=epithelial,
    )


def _epithelial_area(bkg_mask, fov_sum, cfg: SegmentationConfig):
    """Epithelial/debris region detection (biofilm_analysis.py:404-418):
    largest background object, closed with disk(radius), dilated; the
    non-background side is flooded and everything but the largest basin is
    flagged as epithelial area."""
    image_bkg = ~bkg_mask
    image_bkg = lab.remove_small_objects(image_bkg, cfg.bkg_min_size, 1)
    image_bkg = morph.binary_fill_holes(image_bkg)
    closed = morph.binary_closing_disk(image_bkg, cfg.epithelial_disk_radius)
    objs = lab.label(closed, 2, cfg.ccl_max_iters)
    size = objs.size
    flat = jnp.clip(objs.reshape(-1), 0, size)
    counts = jnp.zeros((size + 1,), jnp.int32).at[flat].add(1)
    counts = counts.at[0].set(0)
    biggest = jnp.argmax(counts)
    bkg_final = (objs == biggest) & closed
    bkg_dil = morph.binary_dilation_disk(bkg_final, cfg.epithelial_disk_radius)
    fg_objs = lab.label(~bkg_dil, 2, cfg.ccl_max_iters)
    fg_objs, _ = lab.relabel_sequential(fg_objs)
    flooded = ws.watershed(-fov_sum, fg_objs, None, 1, cfg.watershed_max_iters)
    flat2 = jnp.clip(flooded.reshape(-1), 0, size)
    counts2 = jnp.zeros((size + 1,), jnp.int32).at[flat2].add(1)
    counts2 = counts2.at[0].set(0)
    main = jnp.argmax(counts2)
    return flooded != main
