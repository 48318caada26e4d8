"""Spatially sharded kernels with halo exchange between devices.

The LP-CV stencil needs a (patch_size-1)//2 halo; when a FOV/volume is
sharded across chips along rows, each shard exchanges its boundary strips
with its mesh neighbors via ppermute (one hop each way), then runs the
fused local kernel. This is the device version of the reference's halo'd
CPU tiling (200x200+10, biofilm_analysis.py:900-917) — same decomposition,
but the "tiles" are chips and the halos ride the interconnect.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from hiprfish_tpu.ops import line_profile as lp


def _exchange_row_halos(block: jax.Array, halo: int, axis_name: str):
    """Fetch ``halo`` rows from the previous/next shard along ``axis_name``
    and concatenate: (rows+2*halo, cols). Edge shards pad with edge rows."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    top_strip = block[:halo]          # to send to previous neighbor
    bottom_strip = block[-halo:]      # to send to next neighbor
    # from previous shard: its bottom strip
    from_prev = jax.lax.ppermute(
        bottom_strip, axis_name, [(i, (i + 1) % n) for i in range(n)])
    # from next shard: its top strip
    from_next = jax.lax.ppermute(
        top_strip, axis_name, [(i, (i - 1) % n) for i in range(n)])
    # Edge shards: replicate their own edge rows (edge-pad semantics).
    edge_top = jnp.repeat(block[:1], halo, axis=0)
    edge_bottom = jnp.repeat(block[-1:], halo, axis=0)
    top = jnp.where(idx == 0, edge_top, from_prev)
    bottom = jnp.where(idx == n - 1, edge_bottom, from_next)
    return jnp.concatenate([top, block, bottom], axis=0)


def lp_cv_enhance_2d_sharded(image: jax.Array, mesh, axis_name: str = "tile",
                             patch_size: int = 11, phi_range: int = 9):
    """LP-CV enhancement of an (H, W) image sharded by rows across
    ``axis_name``: halo exchange via ppermute, then the fused local kernel.

    Bitwise-equivalent to lp_cv_enhance_2d on a single device (the halo makes
    shard boundaries exact; only the outer image edge uses edge-padding)."""
    halo = (patch_size - 1) // 2

    def local(block):
        padded_rows = _exchange_row_halos(block, halo, axis_name)
        # Columns are unsharded: plain edge pad. Rows already have halos.
        padded = jnp.pad(padded_rows, ((0, 0), (halo, halo)), mode="edge")
        enhanced = _lp_cv_core(padded, patch_size, phi_range)
        return enhanced

    fn = shard_map(
        local, mesh=mesh,
        in_specs=P(axis_name, None),
        out_specs=P(axis_name, None),
    )
    return fn(image)


def _lp_cv_core(padded: jax.Array, patch_size: int, phi_range: int):
    """Fused LP-CV on an already fully padded block (rows and cols have the
    halo)."""
    table = lp.line_table_2d(patch_size, phi_range)
    h = padded.shape[0] - (patch_size - 1)
    w = padded.shape[1] - (patch_size - 1)
    center = (patch_size - 1) // 2
    rnc = []
    for t in range(phi_range):
        vmin = vmax = vcen = None
        for li in range(patch_size):
            di, dj = int(table[t, li, 0]), int(table[t, li, 1])
            v = jax.lax.slice(padded, (di, dj), (di + h, dj + w))
            vmin = v if vmin is None else jnp.minimum(vmin, v)
            vmax = v if vmax is None else jnp.maximum(vmax, v)
            if li == center:
                vcen = v
        rnc.append((vcen - vmin) / jnp.maximum(vmax - vmin, 1e-8))
    return lp._lp_cv_combine(jnp.stack(rnc, axis=-1))
