"""Fully fused single-program FOV pipeline (the benchmark/production path).

One jitted XLA program takes a multi-laser FOV from raw per-laser planes all
the way to per-cell barcode calls: FFT registration -> NL-means -> fused
LP-CV enhancement -> KMeans -> morphology seeding -> CCL -> watershed ->
sequential relabel -> segment_sum measurement -> check heads -> gated-metric
kNN classification. No host round-trips; every per-cell tensor is bounded by
a static max_cells so shapes stay static.

This is the batched replacement for the reference's Snakemake per-FOV process
fan-out (SURVEY.md §2.1 parallelism table): vmap it over a stacked FOV axis
and shard that axis over a device mesh (parallel/fov_batch.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hiprfish_tpu.config import SegmentationConfig
from hiprfish_tpu.ops import denoise as dn
from hiprfish_tpu.ops import kmeans as km
from hiprfish_tpu.ops import labeling as lab
from hiprfish_tpu.ops import line_profile as lp
from hiprfish_tpu.ops import morphology as morph
from hiprfish_tpu.ops import register as reg
from hiprfish_tpu.ops import segstats
from hiprfish_tpu.models import metrics
from hiprfish_tpu.models.classifier import _mlp_logit
from hiprfish_tpu.ops import watershed as ws


class FovResult(NamedTuple):
    segmentation: jax.Array   # (H, W) int32 sequential labels
    n_cells: jax.Array        # scalar int32
    avgint: jax.Array         # (max_cells, C) mean spectra (row 0 unused)
    avgint_norm: jax.Array    # row-max normalized
    code_idx: jax.Array       # (max_cells,) predicted class index
    max_prob: jax.Array       # (max_cells,) kNN vote fraction
    valid: jax.Array          # (max_cells,) bool cell-slot validity


def segment_lpcv_device(stack, calibration, cfg: SegmentationConfig,
                        max_cells: int, denoise: bool = True,
                        stop_after: str = ""):
    """Pure-device LP-CV segmentation of one FOV (multispecies semantics,
    multispecies_spectral_image_measurement.py:78-157). ``stack`` is a tuple
    of per-laser (H, W, C_l) arrays.

    ``stop_after`` (static, profiling only): truncate after the named stage
    and return a scalar checksum — same prefix-attribution contract and
    caveats as fused_ecoli.segment_ecoli_device (each prefix pays a
    full-tensor checksum the full program doesn't; truncation changes
    fusion; small deltas are noise)."""

    def _ck(x):
        return jnp.sum(x.astype(jnp.float32))

    projections = [jnp.sum(img, axis=2) for img in stack]
    ref0 = projections[0]
    c = cfg.register_crop
    h, w = ref0.shape
    if c and h > c and w > c:
        r0, c0 = (h - c) // 2, (w - c) // 2
        _crop = lambda im: jax.lax.slice(im, (r0, c0), (r0 + c, c0 + c))
    else:
        _crop = lambda im: im
    cref = _crop(ref0)
    # The registered cube is consumed only by the per-cell spectral sums;
    # cfg.registered_dtype (default bf16) halves its roll/concat/stats
    # memory traffic. The KMeans/NLM input (fov_sum) is
    # built from the f32 per-laser 2D sums — already computed for
    # registration — rolled by the same shifts (sum of roll == roll of
    # sum), not by re-reading the cube. The calibrated path keeps f32 and
    # the cube-sum (flat-field division changes the channel weighting).
    reg_dt = jnp.dtype(cfg.registered_dtype) if calibration is None \
        else jnp.float32
    parts = [stack[0].astype(reg_dt)]
    fov_sum = projections[0]
    for i in range(1, len(stack)):
        s = reg.register_translation(cref, _crop(projections[i]))
        if cfg.clamp_shift:
            # backstop for a bad correlation on the sparse centered crop
            # (the reference clamps the ecoli path the same way,
            # spectral_image_measurement.py:54-57)
            s = reg.clamp_shift(s, cfg.max_shift)
        shifted, _ = reg.apply_shift_2d(stack[i].astype(reg_dt), s)
        parts.append(shifted)
        fov_sum = fov_sum + reg.apply_shift_2d(projections[i], s)[0]
    registered = jnp.concatenate(parts, axis=2)
    if calibration is not None:
        registered = registered / calibration
    # Materialize ONCE (same hazard as fused_ecoli: the unaligned minor-dim
    # laser concat otherwise re-fuses into the downstream stats pack).
    registered = jax.lax.optimization_barrier(registered)
    if calibration is not None:
        fov_sum = jnp.sum(registered, axis=2)
    sum_norm = fov_sum / jnp.maximum(jnp.max(fov_sum), 1e-12)
    if stop_after == 'register':
        return _ck(sum_norm), registered
    if denoise:
        den = dn.denoise_nl_means_auto(sum_norm, cfg.nlm_h,
                                       cfg.nlm_patch_size,
                                       cfg.nlm_patch_distance)
    else:
        den = sum_norm
    if stop_after == 'nlm':
        return _ck(den), registered
    enhanced = lp.lp_cv_enhance_2d(den, cfg.patch_size, cfg.phi_range)
    if stop_after == 'enhance':
        return _ck(enhanced), registered

    bkg = km.brightest_cluster_mask(den, 2, cfg.kmeans_iters)
    # Intersect with the intensity background filter before the morphology
    # chain (see segment2d.segment_lpcv_from_registered): same cell seeds,
    # compact CCL inputs.
    fg = km.brightest_cluster_mask(enhanced, 2, cfg.kmeans_iters) & bkg
    if stop_after == 'kmeans':
        return _ck(fg) + _ck(bkg), registered
    # fill(opening(fg)) & fill(fg) == fill(opening(fg)): opening only
    # shrinks, and reachability through ~fg implies reachability through
    # the superset ~opening(fg) — the second border flood was a no-op
    # (same identity as segment3d._segment_one_tile)
    seed_mask = morph.binary_fill_holes(morph.binary_opening(fg),
                                        1, 64)
    if stop_after == 'seeds':
        return _ck(seed_mask), registered

    # Rank the markers to sequential 1..n BEFORE flooding (gather-free
    # presence trick, ops/segstats.py): the watershed then propagates
    # band-local sequential ids directly, which is what makes the one-pass
    # windowed-matmul stats/remap in fov_step possible. Small seeds are
    # filtered AFTER this single CCL by a windowed count pass (the
    # pre-filter remove_small_objects ran a second full CCL); the
    # watershed mask (fg & bkg) is unchanged, sub-threshold fragments just
    # lose their markers.
    # max_run=64: seeds are cell cores; see labeling._run_min_scan
    markers0 = lab.label(seed_mask, 2, cfg.ccl_max_iters, cfg.scan_cap)
    markers_seq, _ = segstats.rank_labels(markers0, 2, cfg.ccl_max_iters,
                                          cfg.scan_cap)
    pre_segments = 2 * max_cells
    markers_seq = jnp.minimum(markers_seq, pre_segments - 1)
    if stop_after == 'ccl':
        return _ck(markers_seq), registered
    st = segstats.label_stats(markers_seq, None, pre_segments, width=256)
    keep_tbl = jnp.where(st.counts >= cfg.lp_seed_min_size,
                         jnp.arange(pre_segments, dtype=jnp.float32),
                         0.0).at[0].set(0.0)
    markers = segstats.label_lookup(markers_seq, keep_tbl,
                                    width=256).astype(jnp.int32) \
        * bkg.astype(jnp.int32)
    if stop_after == 'markers':
        return _ck(markers), registered
    seg = ws.watershed(-(enhanced * bkg), markers, fg & bkg, 1,
                       cfg.watershed_max_iters)
    if stop_after == 'watershed':
        return _ck(seg), registered
    return seg, registered


def classify_device(avgint_norm, check_params, check_blocks, scaler_mean,
                    scaler_scale, train_features, train_labels, n_classes,
                    blocks, check_slice, n_channels, k, temperature):
    """Feature build + check heads + gated-metric kNN vote for a static
    (max_cells, C) spectra block (cf. models/classifier.py, kept free-function
    so it inlines into the fused program)."""
    x = avgint_norm[:, :n_channels]
    scaled = x if scaler_mean is None else (x - scaler_mean) / scaler_scale
    wmax = check_params[0]["w1"].shape[0]
    checks = []
    for params, (lo, hi) in zip(check_params, check_blocks):
        xin = scaled[:, lo:hi] if hi <= n_channels else avgint_norm[:, lo:hi]
        xin = jnp.pad(xin, ((0, 0), (0, wmax - (hi - lo))))
        checks.append((_mlp_logit(params, xin) > 0).astype(jnp.float32))
    feats = jnp.concatenate([avgint_norm, jnp.stack(checks, axis=1)], axis=1)

    d = metrics.block_cosine_distance_matrix(feats, train_features, blocks,
                                             check_slice)
    neg_d, idx = jax.lax.top_k(-d, k)
    nb = train_labels[idx]
    w = jax.nn.softmax(neg_d * temperature, axis=1)
    n = feats.shape[0]
    scores = jnp.zeros((n, n_classes), jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], nb.shape)
    scores = scores.at[rows, nb].add(w)
    return jnp.argmax(scores, axis=1), jnp.max(scores, axis=1)


def classify_capped(spectra_rows, n_cells, cap, *clf_args):
    """classify_device on only the first `cap` of the max_cells-padded rows.

    Real cell counts (~400-2500/FOV) are far below the max_cells=8192 safety
    padding, yet the classifier GEMMs, check-head MLPs and vote scatter all
    ran over every padded row — the 1023-class kNN was a large share of the
    10-bit step. Labels are sequential (1..n_cells), so when
    n_cells < cap only rows [:cap] can hold cells; a lax.cond falls back to
    the full-width program for denser scenes, so results are identical for
    any n_cells.
    """
    n = spectra_rows.shape[0]
    if cap is None or cap >= n:
        return classify_device(spectra_rows, *clf_args)

    def small(rows):
        ci, mp = classify_device(rows[:cap], *clf_args)
        return (jnp.zeros((n,), ci.dtype).at[:cap].set(ci),
                jnp.zeros((n,), mp.dtype).at[:cap].set(mp))

    def full(rows):
        return classify_device(rows, *clf_args)

    return jax.lax.cond(n_cells < cap, small, full, spectra_rows)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def fov_step(stack, clf_arrays, cfg: SegmentationConfig, max_cells: int,
             clf_static, denoise: bool = True,
             classify_cap: int = 2048) -> FovResult:
    """The flagship forward step: raw per-laser planes -> barcode calls.

    clf_arrays: dict of classifier arrays (train_features (N, D) f32,
      train_labels (N,) i32, check params, optional scaler, calibration).
    clf_static: tuple(n_classes, blocks, check_slice, n_channels, k,
      temperature, check_blocks).
    """
    (n_classes, blocks, check_slice, n_channels, k, temperature,
     check_blocks) = clf_static
    seg0, registered = segment_lpcv_device(
        stack, clf_arrays.get("calibration"), cfg, max_cells, denoise)
    # One windowed-matmul pass gives every region's pixel count, border
    # contact and full spectral sum (replaces filter_and_relabel +
    # segment_sum measurement; ops/segstats.py).
    # width 256: ids in one 16k-pixel band span < ~200 even at 8k dense
    # cells (ranks are raster-ordered); a narrower window shrinks the
    # materialized one-hot, the stage's dominant memory traffic. Window
    # spill still falls back to the exact path via lax.cond.
    pre_segments = 2 * max_cells
    stats = segstats.label_stats(seg0, registered, pre_segments, width=256)
    keep = (stats.counts >= cfg.lp_cell_min_size) & (stats.border_hits == 0)
    keep = keep.at[0].set(False)
    final = jnp.cumsum(keep.astype(jnp.int32))
    n_cells = final[-1]
    remap = jnp.where(keep, jnp.minimum(final, max_cells - 1), 0)
    seg = segstats.label_lookup(seg0, remap, width=256).astype(jnp.int32)
    means = stats.sums / jnp.maximum(stats.counts, 1.0)[:, None]
    avgint = jnp.zeros((max_cells, means.shape[1]), jnp.float32) \
        .at[remap].set(means)
    avgint = avgint.at[0].set(0.0)
    avgint_norm = avgint / jnp.maximum(
        jnp.max(avgint, axis=1, keepdims=True), 1e-12)
    code_idx, max_prob = classify_capped(
        avgint_norm, n_cells, classify_cap,
        clf_arrays["check_params"],
        check_blocks,
        clf_arrays.get("scaler_mean"),
        clf_arrays.get("scaler_scale"),
        clf_arrays["train_features"],
        clf_arrays["train_labels"],
        n_classes, blocks, check_slice, n_channels, k, temperature,
    )
    valid = jnp.arange(max_cells) <= n_cells
    valid = valid & (jnp.arange(max_cells) > 0)
    return FovResult(seg, n_cells, avgint, avgint_norm, code_idx, max_prob,
                     valid)


def classifier_to_device_args(clf):
    """Split a SpectralClassifier into (arrays pytree, static tuple) for
    fov_step."""
    arrays = {
        "train_features": jnp.asarray(clf.train_features),
        "train_labels": jnp.asarray(clf.train_labels),
        "check_params": tuple(
            {k: jnp.asarray(v) for k, v in p.items()} for p in clf.check_params
        ),
    }
    if clf.scaler_mean is not None:
        arrays["scaler_mean"] = jnp.asarray(clf.scaler_mean, jnp.float32)
        arrays["scaler_scale"] = jnp.asarray(clf.scaler_scale, jnp.float32)
    static = (
        len(clf.codebook),
        tuple(clf.blocks),
        tuple(clf.check_slice),
        clf.n_channels,
        clf.n_neighbors,
        clf.temperature,
        tuple(clf.check_blocks),
    )
    return arrays, static
