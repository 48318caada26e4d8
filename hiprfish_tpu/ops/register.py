"""FFT cross-correlation translation registration.

Equivalent of skimage.feature.register_translation as used by the
reference for channel registration (spectral_image_measurement.py:46,
biofilm_analysis.py:327): whole-pixel shifts from the argmax of the FFT
cross-correlation, then a masked integer shift of the moving image.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def register_translation(reference: jax.Array, moving: jax.Array) -> jax.Array:
    """Integer (row, col) shift aligning ``moving`` to ``reference``.

    Phase correlation: argmax of ifft2 of the normalized cross-power
    spectrum. (The reference uses plain cross-correlation via skimage
    register_translation; phase normalization keeps the same answer on its
    data but is robust to sparse scenes, where raw cross-correlation can
    lock onto a spurious bright-region overlap.)
    """
    f_ref = jnp.fft.rfft2(reference.astype(jnp.float32))
    f_mov = jnp.fft.rfft2(moving.astype(jnp.float32))
    cross = f_ref * jnp.conj(f_mov)
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-12)
    cc_abs = jnp.abs(jnp.fft.irfft2(cross, reference.shape))
    flat = jnp.argmax(cc_abs)
    shape = jnp.asarray(reference.shape)
    maxima = jnp.stack(jnp.unravel_index(flat, reference.shape)).astype(jnp.float32)
    midpoints = (shape // 2).astype(jnp.float32)
    shifts = jnp.where(maxima > midpoints, maxima - shape, maxima)
    return shifts


@jax.jit
def register_translation_3d(reference: jax.Array, moving: jax.Array) -> jax.Array:
    """3D variant (used for z-stack time registration, biofilm_analysis.py:143)."""
    f_ref = jnp.fft.fftn(reference.astype(jnp.float32))
    f_mov = jnp.fft.fftn(moving.astype(jnp.float32))
    cross = f_ref * jnp.conj(f_mov)
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-12)
    cc_abs = jnp.abs(jnp.fft.ifftn(cross))
    flat = jnp.argmax(cc_abs)
    shape = jnp.asarray(reference.shape)
    maxima = jnp.stack(jnp.unravel_index(flat, reference.shape)).astype(jnp.float32)
    midpoints = (shape // 2).astype(jnp.float32)
    return jnp.where(maxima > midpoints, maxima - shape, maxima)


@jax.jit
def apply_shift_2d(image: jax.Array, shift: jax.Array):
    """Shift an (H, W, ...) image by integer (row, col) and return
    (shifted, valid_mask).

    Reproduces the reference's slice-copy registration (zeros outside the
    overlap, True mask inside; spectral_image_measurement.py:59-68) via roll +
    coordinate masking, which is jit-friendly for traced shifts.
    """
    sr = shift[0].astype(jnp.int32)
    sc = shift[1].astype(jnp.int32)
    h, w = image.shape[0], image.shape[1]
    rolled = jnp.roll(image, (sr, sc), axis=(0, 1))
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    valid = (
        (rows - sr >= 0) & (rows - sr < h) & (cols - sc >= 0) & (cols - sc < w)
    )
    mask = valid
    if image.ndim > 2:
        valid = valid.reshape(valid.shape + (1,) * (image.ndim - 2))
    return rolled * valid.astype(rolled.dtype), mask


@jax.jit
def apply_shift_3d(volume: jax.Array, shift: jax.Array):
    """3D integer shift of an (X, Y, Z, ...) volume with validity mask."""
    sx = shift[0].astype(jnp.int32)
    sy = shift[1].astype(jnp.int32)
    sz = shift[2].astype(jnp.int32)
    x, y, z = volume.shape[0], volume.shape[1], volume.shape[2]
    rolled = jnp.roll(volume, (sx, sy, sz), axis=(0, 1, 2))
    xi = jax.lax.broadcasted_iota(jnp.int32, (x, y, z), 0)
    yi = jax.lax.broadcasted_iota(jnp.int32, (x, y, z), 1)
    zi = jax.lax.broadcasted_iota(jnp.int32, (x, y, z), 2)
    valid = (
        (xi - sx >= 0) & (xi - sx < x)
        & (yi - sy >= 0) & (yi - sy < y)
        & (zi - sz >= 0) & (zi - sz < z)
    )
    mask = valid
    if volume.ndim > 3:
        valid = valid.reshape(valid.shape + (1,) * (volume.ndim - 3))
    return rolled * valid.astype(rolled.dtype), mask


@functools.partial(jax.jit, static_argnums=(2,))
def clamp_shift(shift: jax.Array, max_shift: float, enabled: bool = True):
    """Zero out implausibly large shifts (spectral_image_measurement.py:54-57)."""
    if not enabled:
        return shift
    return jnp.where(jnp.abs(shift) > max_shift, 0.0, shift)


def register_stack_2d(images_sum, max_shift: float | None = 15.0):
    """Shifts for a list/stack of (H, W) projections against the first one.

    Returns (n, 2) float shifts, first row zeros.
    """
    ref = images_sum[0]
    shifts = [jnp.zeros((2,), jnp.float32)]
    for i in range(1, len(images_sum)):
        s = register_translation(ref, images_sum[i])
        if max_shift is not None:
            s = clamp_shift(s, max_shift)
        shifts.append(s)
    return jnp.stack(shifts)
