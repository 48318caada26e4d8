"""Per-label region properties via segmented reductions.

The reference loops skimage.measure.regionprops over every spectral channel —
95 full-image passes per FOV (spectral_image_measurement.py:153-155) plus
per-cell shape passes. Here every property lowers to one scatter-add
(segment_sum) over the label image, and *all* channels are reduced in a single
pass: mean spectra for C channels is one (N_pixels, C) scatter-add
(SURVEY.md §7).

Shape properties (centroid, axis lengths, eccentricity, orientation) follow
skimage's central-moment definitions (regionprops docs): inertia eigenvalues
lambda1 >= lambda2, major_axis = 4*sqrt(lambda1),
eccentricity = sqrt(1 - lambda2/lambda1),
orientation in (-pi/2, pi/2] measured against the row axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnums=(2,))
def mean_intensities(labels: jax.Array, image: jax.Array, num_segments: int):
    """Per-label mean of every channel in one pass.

    Args:
      labels: (H, W) or (X, Y, Z) int labels, 0 = background.
      image: labels.shape + (C,) intensity image.
      num_segments: static label-count bound (incl. background slot 0).

    Returns (num_segments, C) means (row 0 = background; rows for absent
    labels are 0).
    """
    flat_lbl = labels.reshape(-1).astype(jnp.int32)
    flat_img = image.reshape(-1, image.shape[-1]).astype(jnp.float32)
    sums = jax.ops.segment_sum(flat_img, flat_lbl, num_segments=num_segments)
    counts = jax.ops.segment_sum(
        jnp.ones_like(flat_lbl, dtype=jnp.float32), flat_lbl, num_segments=num_segments
    )
    return sums / jnp.maximum(counts, 1.0)[:, None]


@functools.partial(jax.jit, static_argnums=(2,))
def max_intensities(labels: jax.Array, image: jax.Array, num_segments: int):
    flat_lbl = labels.reshape(-1).astype(jnp.int32)
    flat_img = image.reshape(-1, image.shape[-1]).astype(jnp.float32)
    return jax.ops.segment_max(
        flat_img, flat_lbl, num_segments=num_segments, indices_are_sorted=False
    )


@functools.partial(jax.jit, static_argnums=(1,))
def shape_props_2d(labels: jax.Array, num_segments: int):
    """Per-label 2D shape properties in one fused pass.

    Returns dict of (num_segments,) arrays: area, centroid_r, centroid_c,
    major_axis_length, minor_axis_length, eccentricity, orientation.
    """
    h, w = labels.shape
    flat = labels.reshape(-1).astype(jnp.int32)
    rows = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0).reshape(-1)
    cols = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1).reshape(-1)
    ones = jnp.ones_like(rows)
    feats = jnp.stack(
        [ones, rows, cols, rows * rows, cols * cols, rows * cols], axis=-1
    )
    sums = jax.ops.segment_sum(feats, flat, num_segments=num_segments)
    n = jnp.maximum(sums[:, 0], 1.0)
    rbar = sums[:, 1] / n
    cbar = sums[:, 2] / n
    # Central second moments normalized by area (skimage mu'_pq), with the
    # +1/12 pixel-extent correction skimage applies via its inertia tensor.
    mu20 = sums[:, 3] / n - rbar * rbar + 1.0 / 12.0
    mu02 = sums[:, 4] / n - cbar * cbar + 1.0 / 12.0
    mu11 = sums[:, 5] / n - rbar * cbar
    common = jnp.sqrt(jnp.maximum((mu20 - mu02) ** 2 + 4 * mu11 * mu11, 0.0))
    lam1 = (mu20 + mu02 + common) / 2.0
    lam2 = (mu20 + mu02 - common) / 2.0
    lam1 = jnp.maximum(lam1, 1e-12)
    lam2 = jnp.clip(lam2, 0.0, None)
    major = 4.0 * jnp.sqrt(lam1)
    minor = 4.0 * jnp.sqrt(lam2)
    ecc = jnp.sqrt(jnp.clip(1.0 - lam2 / lam1, 0.0, 1.0))
    # skimage orientation: angle from the row axis, in (-pi/2, pi/2]
    # (0 = elongated along rows; +pi/2 = elongated along columns).
    orientation = 0.5 * jnp.arctan2(-2.0 * mu11, mu20 - mu02)
    return {
        "area": sums[:, 0],
        "centroid_r": rbar,
        "centroid_c": cbar,
        "major_axis_length": major,
        "minor_axis_length": minor,
        "eccentricity": ecc,
        "orientation": orientation,
    }


@functools.partial(jax.jit, static_argnums=(1,))
def shape_props_3d(labels: jax.Array, num_segments: int):
    """Per-label 3D area + centroid (biofilm 3D cell_info columns)."""
    x, y, z = labels.shape
    flat = labels.reshape(-1).astype(jnp.int32)
    xi = jax.lax.broadcasted_iota(jnp.float32, (x, y, z), 0).reshape(-1)
    yi = jax.lax.broadcasted_iota(jnp.float32, (x, y, z), 1).reshape(-1)
    zi = jax.lax.broadcasted_iota(jnp.float32, (x, y, z), 2).reshape(-1)
    feats = jnp.stack([jnp.ones_like(xi), xi, yi, zi], axis=-1)
    sums = jax.ops.segment_sum(feats, flat, num_segments=num_segments)
    n = jnp.maximum(sums[:, 0], 1.0)
    return {
        "area": sums[:, 0],
        "centroid_x": sums[:, 1] / n,
        "centroid_y": sums[:, 2] / n,
        "centroid_z": sums[:, 3] / n,
    }


@functools.partial(jax.jit, static_argnums=(2,))
def label_overlap_any(labels: jax.Array, mask: jax.Array, num_segments: int):
    """Per-label: does the region overlap ``mask`` (debris/epithelial filter,
    biofilm_analysis.py:1259-1267)."""
    flat = labels.reshape(-1).astype(jnp.int32)
    hit = jax.ops.segment_max(
        mask.reshape(-1).astype(jnp.int32), flat, num_segments=num_segments
    )
    return hit > 0
