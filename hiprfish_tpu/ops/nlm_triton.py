"""Fast-mode NL-means as one Pallas kernel through Triton (GPU).

Same semantics as ops/denoise.denoise_nl_means (reflect pad by
patch_distance + patch radius, weight exp(-patch-mean squared difference /
h^2), accumulated over the full (2d+1)^2 search window).

The XLA scan writes and re-reads full-image accumulators and a rolled copy
of the image for each of its offsets. Here each program owns one output
tile: it loads a ``block x block`` window of the padded image once, and for
every search offset loads the shifted window (an L1/L2 hit: neighbouring
offsets overlap almost entirely), forms the squared difference, and box
filters it with two dots against a banded 0/1 matrix on the tensor cores.
Accumulators stay in registers for the whole offset loop; the image is read
from device memory about once.

A window of ``block`` rows yields ``block - 2 * radius`` output rows (the
box sum of the outer ``radius`` rows is partial), so neighbouring programs'
windows overlap by ``2 * radius`` and each stores only its interior.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _nlm_kernel(img_ref, out_ref, *, block, pd, pr, inv, precision):
    t = block - 2 * pr
    r0 = pl.program_id(0) * t
    c0 = pl.program_id(1) * t
    n_off = 2 * pd + 1
    ri = jax.lax.broadcasted_iota(jnp.int32, (block, block), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (block, block), 1)
    band = (jnp.abs(ri - ci) <= pr).astype(jnp.float32)
    # window origin of offset (0, 0) in padded coordinates
    x = img_ref[pl.ds(r0 + pd, block), pl.ds(c0 + pd, block)]

    def body(k, carry):
        acc, wacc = carry
        dy = jax.lax.div(k, n_off)       # k >= 0: plain integer ops
        dx = jax.lax.rem(k, n_off)
        y = img_ref[pl.ds(r0 + dy, block), pl.ds(c0 + dx, block)]
        d = (x - y) * (x - y)
        s = jnp.dot(jnp.dot(band, d, precision=precision), band,
                    precision=precision)
        w = jnp.exp(jnp.maximum(s, 0.0) * inv)
        return acc + w * y, wacc + w

    zeros = jnp.zeros((block, block), jnp.float32)
    acc, wacc = jax.lax.fori_loop(0, n_off * n_off, body, (zeros, zeros))
    interior = ((ri >= pr) & (ri < block - pr)
                & (ci >= pr) & (ci < block - pr))
    plgpu.store(out_ref.at[pl.ds(r0, block), pl.ds(c0, block)],
                acc / wacc, mask=interior)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def denoise_nl_means_triton(image: jax.Array, h: float = 0.02,
                            patch_size: int = 7, patch_distance: int = 11,
                            block: int = 64, num_warps: int = 4,
                            interpret: bool = False):
    """Pallas-Triton NL-means of an (H, W) image; drop-in for
    denoise.denoise_nl_means. ``block`` (a power of two > patch_size)
    and ``num_warps`` are scheduling knobs; ``interpret`` runs the kernel
    under the Pallas interpreter (CPU tests)."""
    img = image.astype(jnp.float32)
    hh, ww = img.shape
    pd = patch_distance
    pr = patch_size // 2
    t = block - 2 * pr
    gh = -(-hh // t)
    gw = -(-ww // t)
    pad = pd + pr
    padded = jnp.pad(img, pad, mode="reflect")
    # zero-extend so the last programs' shifted windows stay in bounds (the
    # extension only feeds outputs past the image edge, which are dropped)
    need_h = (gh - 1) * t + 2 * pd + block
    need_w = (gw - 1) * t + 2 * pd + block
    padded = jnp.pad(padded, ((0, need_h - padded.shape[0]),
                              (0, need_w - padded.shape[1])))
    # exact f32 box sums: tf32x3 on the tensor cores (the band is 0/1, so
    # only the squared differences are split); the interpreter runs f32
    precision = (jax.lax.Precision.HIGHEST if interpret
                 else jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3)
    kernel = functools.partial(
        _nlm_kernel, block=block, pd=pd, pr=pr,
        inv=-1.0 / (patch_size * patch_size * h * h), precision=precision)
    out = pl.pallas_call(
        kernel,
        grid=(gh, gw),
        out_shape=jax.ShapeDtypeStruct((gh * t + 2 * pr, gw * t + 2 * pr),
                                       jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="nlm_triton",
    )(padded)
    return out[pr:pr + hh, pr:pr + ww]
