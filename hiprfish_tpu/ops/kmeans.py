"""Jitted Lloyd KMeans for 1-D intensity clustering.

The reference calls sklearn KMeans(n_clusters=2 or 3, random_state=0) on
flattened pixel intensities 14x across the repo to split foreground from
background (e.g. hiprfish_imaging_spectral_image_measurement.py:73,85;
hiprfish_imaging_multispecies_spectral_image_measurement.py:125,141). The
downstream logic only consumes "cluster with the highest mean intensity", so a
deterministic fixed-iteration Lloyd solver with quantile seeding reproduces the
behavior while staying inside jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _value_histogram(values: jax.Array, n_bins: int):
    """(counts, bin_val, vmin, vmax, span) — the shared Lloyd substrate.

    Statistical: built from a strided subsample (assignment on the full
    data stays exact downstream) — the full-size scatter otherwise
    dominates the whole call."""
    v = values.reshape(-1).astype(jnp.float32)
    vmin = jnp.min(v)
    vmax = jnp.max(v)
    span = jnp.maximum(vmax - vmin, 1e-12)
    max_hist = 1 << 19
    if v.shape[0] > max_hist:
        # Subsample whole contiguous 512-element blocks at a row stride,
        # not a flat element stride: v[::7] is a strided gather that can
        # cost more than the histogram scatter itself (same statistics).
        blk = 512
        nb = v.shape[0] // blk
        stride = -(-nb * blk // max_hist)
        vs = v[:nb * blk].reshape(nb, blk)[::stride].reshape(-1)
    else:
        vs = v
    idx = jnp.clip(((vs - vmin) / span * (n_bins - 1)).astype(jnp.int32), 0, n_bins - 1)
    # One fused scatter for [count, value] instead of two — the scatter is
    # the full-size pass of the whole call.
    cs = jnp.zeros((n_bins, 2), jnp.float32).at[idx].add(
        jnp.stack([jnp.ones_like(vs), vs], axis=-1))
    counts = cs[:, 0]
    sums = cs[:, 1]
    bin_centers = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), 0.0)
    bin_pos = vmin + (jnp.arange(n_bins, dtype=jnp.float32) + 0.5) / n_bins * span
    bin_val = jnp.where(counts > 0, bin_centers, bin_pos)
    return counts, bin_val, vmin, vmax, span


def _lloyd_from_histogram(counts, bin_val, vmin, vmax, span, k: int,
                          iters: int):
    """Multi-start Lloyd over a fixed histogram; sorted-ascending centers."""

    def step(centers, _):
        d = jnp.abs(bin_val[:, None] - centers[None, :])
        assign = jnp.argmin(d, axis=1)
        one_hot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
        w = one_hot * counts[:, None]
        new = (w * bin_val[:, None]).sum(0) / jnp.maximum(w.sum(0), 1e-12)
        new = jnp.where(w.sum(0) > 0, new, centers)
        return new, None

    def lloyd(init_centers):
        centers, _ = jax.lax.scan(step, init_centers, None, length=iters)
        d = jnp.abs(bin_val[:, None] - centers[None, :])
        inertia = jnp.sum(counts * jnp.min(d, axis=1) ** 2)
        return centers, inertia

    # Deterministic multi-start (the sklearn n_init analogue): quantile
    # spread handles balanced modes, value-range spread rescues the
    # tiny-bright-mode case (cells a small pixel fraction of the FOV), and a
    # max-anchored start guarantees a basin for a far-out bright mode.
    # Quantiles come from the histogram CDF (searchsorted over n_bins)
    # instead of a full O(N log N) sort of the image.
    n_bins = counts.shape[0]
    qs = (jnp.arange(k, dtype=jnp.float32) + 0.5) / k
    cdf = jnp.cumsum(counts)
    qbins = jnp.searchsorted(cdf, qs * cdf[-1])
    quant = bin_val[jnp.clip(qbins, 0, n_bins - 1)]
    inits = jnp.stack(
        [quant, vmin + qs * span, jnp.concatenate([quant[:-1], vmax[None]])]
    )
    all_centers, inertias = jax.vmap(lloyd)(inits)
    centers = all_centers[jnp.argmin(inertias)]
    return jnp.sort(centers)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def kmeans1d_centers(values: jax.Array, k: int, iters: int = 40,
                     n_bins: int = 2048):
    """Sorted-ascending cluster centers only — no full-size assignment.

    The (N, k) distance matrix of the final labeling is the only O(N*k)
    buffer in kmeans1d; on gigavoxel volumes that alone is several GB, and
    callers that just need a decision threshold (the tiled 3D engine) never
    want it.
    """
    return _lloyd_from_histogram(*_value_histogram(values, n_bins), k, iters)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def kmeans1d_centers_multi(values: jax.Array, ks: tuple, iters: int = 40,
                           n_bins: int = 2048):
    """Centers for several k over ONE shared histogram of the same values.

    The engines threshold the same log-intensity image with k=2 (foreground)
    and k=3 (interior) back to back; the histogram scatter is the dominant
    cost of each call, so sharing it halves the pair."""
    hist = _value_histogram(values, n_bins)
    return tuple(_lloyd_from_histogram(*hist, k, iters) for k in ks)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def kmeans1d(values: jax.Array, k: int, iters: int = 40, n_bins: int = 2048):
    """Cluster scalar values into k groups with histogram-accelerated Lloyd.

    The N-point Lloyd update is collapsed onto a fixed n_bins histogram of the
    value range: O(n_bins * k) per iteration instead of O(N * k), with
    identical fixed points up to bin resolution. Returns (labels, centers)
    with centers sorted ascending so cluster k-1 is always the brightest.
    """
    centers = kmeans1d_centers(values, k, iters, n_bins)
    v = values.reshape(-1).astype(jnp.float32)
    labels = jnp.argmin(jnp.abs(v[:, None] - centers[None, :]), axis=1)
    return labels.reshape(values.shape).astype(jnp.int32), centers


def brightest_cluster_mask(image: jax.Array, k: int = 2, iters: int = 40):
    """Boolean mask of the cluster with the highest center.

    Mirrors the reference's "compare per-cluster mean intensity, keep the
    brighter one" idiom (spectral_image_measurement.py:75-84). Membership in
    the brightest cluster is exactly ``value >= midpoint of the two highest
    centers`` (1-D nearest-center), so the (N, k) argmin pass is skipped."""
    centers = kmeans1d_centers(image, k, iters)
    return image >= (centers[-1] + centers[-2]) / 2.0


def brightest_cluster_masks(image: jax.Array, ks: tuple = (2, 3),
                            iters: int = 40):
    """brightest_cluster_mask for several k sharing one histogram."""
    all_centers = kmeans1d_centers_multi(image, tuple(ks), iters)
    return tuple(image >= (c[-1] + c[-2]) / 2.0 for c in all_centers)


def darkest_cluster_mask(image: jax.Array, k: int = 2, iters: int = 40):
    labels, centers = kmeans1d(image, k, iters)
    return labels == 0
