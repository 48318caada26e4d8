"""Non-local-means denoising.

Replaces skimage.restoration.denoise_nl_means(h=0.02) used ahead of the LP-CV
enhancement (multispecies_spectral_image_measurement.py:108,
biofilm_analysis.py:350). The fast-mode NLM algorithm — per search offset,
compare patch means via a box filter of the squared difference image —
vectorizes cleanly: lax.scan over the (2d+1)^2 search offsets, each step a
roll + box filter + fused exp/accumulate. The box filter is a separable
sum of statically shifted slices, which XLA fuses into the step.

``denoise_nl_means`` is the plain reference; ``denoise_nl_means_auto``
picks the Pallas-Triton kernel (ops/nlm_triton.py) where the platform
policy says it is faster (utils/platform.policy).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _box_mean(img: jax.Array, size: int):
    """Mean filter with a (size x size) window, edge-padded, same-size out:
    a separable sum of ``size`` statically shifted slices per axis (one
    fused elementwise pass each, and no cumulative-sum cancellation)."""
    half = size // 2
    h, w = img.shape
    p = jnp.pad(img, half, mode="edge")
    rows = sum(p[k:k + h, :] for k in range(size))
    out = sum(rows[:, k:k + w] for k in range(size))
    return out / (size * size)


@functools.partial(jax.jit, static_argnums=(1, 2))
def estimate_sigma(image: jax.Array, *_args, **_kwargs):
    """Robust noise-sigma estimate (median absolute deviation of the
    Laplacian-like residual). The reference computes skimage's wavelet
    estimate but never uses the value (multispecies...py:107) — kept for API
    parity."""
    img = image.astype(jnp.float32)
    dx = img[1:, :] - img[:-1, :]
    return jnp.median(jnp.abs(dx)) / 0.6745 / jnp.sqrt(2.0)


@functools.partial(jax.jit, static_argnums=(2, 3))
def denoise_nl_means(
    image: jax.Array,
    h: float = 0.02,
    patch_size: int = 7,
    patch_distance: int = 11,
):
    """Fast-mode non-local means of an (H, W) image.

    weight(offset) = exp(-max(d2, 0) / h^2) with d2 the (size^2-normalized)
    patch-mean squared difference, accumulated over all offsets in the
    (2*patch_distance+1)^2 search window — the skimage fast_mode formulation
    with sigma = 0.
    """
    img = image.astype(jnp.float32)
    pd = patch_distance
    # Pad by the search distance plus the patch radius (skimage's margin):
    # every patch of every offset an output pixel reads then lies inside
    # the reflected image, so jnp.roll's wrap-around never reaches it.
    pad = pd + patch_size // 2
    padded = jnp.pad(img, pad, mode="reflect")

    # Only half the search window is scanned: the patch distance is
    # symmetric, D_{-o}(p) = D_o(p+o), so each offset o also yields the -o
    # contribution via one roll of the weighted image — halving the box
    # filters (the expensive part of each step).
    half = [
        (dy, dx)
        for dy in range(-pd, pd + 1)
        for dx in range(-pd, pd + 1)
        if (dy, dx) > (0, 0)
    ]
    offsets = jnp.asarray(np.array(half), jnp.int32)

    h2 = jnp.float32(h * h)

    def step(carry, off):
        acc, wacc = carry
        shifted_img = jnp.roll(padded, (off[0], off[1]), axis=(0, 1))
        d2 = _box_mean((padded - shifted_img) ** 2, patch_size)
        wgt = jnp.exp(-jnp.maximum(d2, 0.0) / h2)
        # +o contribution at p, and the mirrored -o contribution at p+o.
        acc = acc + wgt * shifted_img
        wacc = wacc + wgt
        acc = acc + jnp.roll(wgt * padded, (-off[0], -off[1]), axis=(0, 1))
        wacc = wacc + jnp.roll(wgt, (-off[0], -off[1]), axis=(0, 1))
        return (acc, wacc), None

    # Self term (offset 0): weight exp(0) = 1.
    (acc, wacc), _ = jax.lax.scan(
        step, (padded, jnp.ones_like(padded)), offsets
    )
    out = acc / jnp.maximum(wacc, 1e-12)
    return out[pad:-pad, pad:-pad]


def denoise_nl_means_auto(image, h: float = 0.02, patch_size: int = 7,
                          patch_distance: int = 11):
    """Dispatcher decided at trace time by the platform policy: the
    Pallas-Triton kernel where it is the measured winner, the XLA scan
    elsewhere."""
    from hiprfish_tpu.utils.platform import policy

    if policy().nlm_kernel == "triton":
        from hiprfish_tpu.ops.nlm_triton import denoise_nl_means_triton

        return denoise_nl_means_triton(image, h, patch_size, patch_distance)
    return denoise_nl_means(image, h, patch_size, patch_distance)
