"""Binary morphology as fused shift/min/max ops + FFT for large elements.

Replaces the skimage morphology calls in the reference's segmentation engines
(binary_erosion/opening/fill_holes: spectral_image_measurement.py:95-122,
multispecies_spectral_image_measurement.py:136-139; disk(100)
closing/dilation for epithelial-region detection: biofilm_analysis.py:407-413).

Design notes:
  * Small structuring elements (the default cross) are unions/intersections of
    statically shifted copies — fully fused element-wise.
  * disk(r) for r ~ 100 would need 2r+1 shifted copies per op; instead
    dilation by a disk is computed as an FFT convolution with the disk kernel
    thresholded at > 0.5 — O(HW log HW) regardless of radius.
  * fill-holes routes through connected-component labeling of the complement.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from hiprfish_tpu.ops.labeling import label, shifted


def _cross_shifts(ndim: int):
    shifts = []
    for ax in range(ndim):
        for o in (-1, 1):
            off = [0] * ndim
            off[ax] = o
            shifts.append(tuple(off))
    return shifts


@jax.jit
def binary_erosion(mask: jax.Array):
    """Erosion with the default cross footprint (out-of-image = foreground,
    matching skimage's border handling)."""
    m = mask.astype(bool)
    out = m
    for off in _cross_shifts(mask.ndim):
        out = out & shifted(m, off, True)
    return out


@jax.jit
def binary_dilation(mask: jax.Array):
    """Dilation with the default cross footprint."""
    m = mask.astype(bool)
    out = m
    for off in _cross_shifts(mask.ndim):
        out = out | shifted(m, off, False)
    return out


@jax.jit
def binary_opening(mask: jax.Array):
    return binary_dilation(binary_erosion(mask))


@jax.jit
def binary_closing(mask: jax.Array):
    return binary_erosion(binary_dilation(mask))


def disk_kernel(radius: int) -> np.ndarray:
    """skimage.morphology.disk: pixels with L2 distance <= radius."""
    y, x = np.ogrid[-radius : radius + 1, -radius : radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


@functools.partial(jax.jit, static_argnums=(1,))
def binary_dilation_disk(mask: jax.Array, radius: int):
    """Dilation by disk(radius) via FFT convolution (mask (H, W))."""
    h, w = mask.shape
    k = disk_kernel(radius)
    kh, kw = k.shape
    fh, fw = h + kh - 1, w + kw - 1
    # Round up to the next even size for FFT efficiency.
    fh += fh % 2
    fw += fw % 2
    fm = jnp.fft.rfft2(mask.astype(jnp.float32), (fh, fw))
    fk = jnp.fft.rfft2(jnp.asarray(k), (fh, fw))
    conv = jnp.fft.irfft2(fm * fk, (fh, fw))
    out = jax.lax.slice(conv, (radius, radius), (radius + h, radius + w))
    return out > 0.5


@functools.partial(jax.jit, static_argnums=(1,))
def binary_erosion_disk(mask: jax.Array, radius: int):
    return ~binary_dilation_disk(~mask, radius)


@functools.partial(jax.jit, static_argnums=(1,))
def binary_closing_disk(mask: jax.Array, radius: int):
    """Closing by disk(radius) (biofilm_analysis.py:407-408)."""
    return binary_erosion_disk(binary_dilation_disk(mask, radius), radius)


@functools.partial(jax.jit, static_argnums=(1, 2))
def binary_fill_holes(mask: jax.Array, connectivity: int = 1,
                      max_run: int | None = None):
    """Fill background regions not connected to the border
    (scipy.ndimage.binary_fill_holes) — a border-seeded binary flood through
    the complement (no label ids, no scatter/gather).

    ``max_run`` (static) caps the or-scans' Hillis-Steele doubling distance.
    The unbounded doubling tree dominated XLA COMPILE time of the 3D tile
    program (~28 unrolled shift steps per axis-direction per flood, twice
    via the coarse+fine route); a cap
    shrinks the loop body ~4x while the flood's while_loop still iterates
    to its exact fixed point — after coarse-block seeding the fine flood
    converges in a couple of rounds regardless, so a cap only slows the
    pathological thin-corridor case, never changes the result."""
    from hiprfish_tpu.ops.labeling import border_mask, flood_reach

    m = mask.astype(bool)
    comp = ~m
    reach = flood_reach(border_mask(mask.shape), comp, connectivity,
                        max_run=max_run)
    return m | (comp & ~reach)


@functools.partial(jax.jit, static_argnums=(1, 2))
def remove_small_holes(mask: jax.Array, area_threshold: int = 64, connectivity: int = 1):
    """Fill holes smaller than area_threshold (skimage remove_small_holes)."""
    m = mask.astype(bool)
    comp = ~m
    lbl = label(comp, connectivity)
    size = mask.size
    flat = jnp.clip(lbl.reshape(-1), 0, size)
    border = jnp.zeros(mask.shape, bool)
    for ax in range(mask.ndim):
        idx = [slice(None)] * mask.ndim
        idx[ax] = 0
        border = border.at[tuple(idx)].set(True)
        idx[ax] = mask.shape[ax] - 1
        border = border.at[tuple(idx)].set(True)
    touches = jnp.zeros((size + 1,), jnp.int32).at[
        jnp.where(border.reshape(-1), flat, 0)
    ].set(1)
    touches = touches.at[0].set(1)
    counts = jnp.zeros((size + 1,), jnp.int32).at[flat].add(1)
    small_hole = (
        (touches[flat].reshape(mask.shape) == 0)
        & (counts[flat].reshape(mask.shape) < area_threshold)
        & comp
    )
    return m | small_hole


@jax.jit
def sobel_magnitude(image: jax.Array):
    """Sobel gradient magnitude, normalized like skimage.filters.sobel
    (used for the RAG boundary map, biofilm_analysis.py:1277)."""
    img = image.astype(jnp.float32)
    kx = jnp.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], jnp.float32) / 4.0
    ky = kx.T
    pad = jnp.pad(img, 1, mode="edge")

    def conv3(k):
        acc = jnp.zeros_like(img)
        for di in range(3):
            for dj in range(3):
                acc = acc + k[di, dj] * jax.lax.slice(
                    pad, (di, dj), (di + img.shape[0], dj + img.shape[1])
                )
        return acc

    gx = conv3(ky)
    gy = conv3(kx)
    return jnp.sqrt(gx * gx + gy * gy) / jnp.sqrt(2.0)
