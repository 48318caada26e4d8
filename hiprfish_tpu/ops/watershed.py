"""Marker-controlled watershed as iterative minimax-cost label propagation.

The reference floods cells with skimage.morphology.watershed(-enhanced image,
seeds, mask) (spectral_image_measurement.py:113,
multispecies_spectral_image_measurement.py:154, biofilm_analysis.py:399-400).
Priority-queue flooding is inherently sequential; the formulation here is
the image-foresting-transform watershed: every masked pixel is assigned to the
marker reachable with the smallest "minimax" path cost, where a path's cost is
the maximum surface height along it. Iterating

    cost[p] <- min over neighbors q of max(cost[q], surface[p])

to a fixed point (adopting the argmin neighbor's label, ties broken toward the
smaller label) yields a deterministic watershed that agrees with the flooding
watershed away from plateau ties. Each iteration is a handful of fused shifts
+ element-wise selects; convergence needs O(basin diameter) iterations, run
under lax.while_loop with an early exit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hiprfish_tpu.ops.labeling import _neighbor_shifts, shifted

# Python float, not a jnp array — see ops/segstats.py:_INF for why.
_BIG = 3.4e38


@functools.partial(jax.jit, static_argnums=(3, 4))
def watershed(
    surface: jax.Array,
    markers: jax.Array,
    mask: jax.Array | None = None,
    connectivity: int = 1,
    max_iters: int = 1024,
):
    """Flood ``surface`` (lower = flooded first) from ``markers`` within ``mask``.

    Args:
      surface: (H, W) or (X, Y, Z) float topography (use -image to grow from
        bright ridges, as the reference does).
      markers: int labels, 0 = unlabeled.
      mask: bool; pixels outside are never labeled. Defaults to all-true.
      connectivity: neighborhood order (1 = faces, like skimage default).
      max_iters: static iteration bound.

    Returns int32 labels of the same shape.
    """
    surf = surface.astype(jnp.float32)
    if mask is None:
        mask = jnp.ones(surf.shape, bool)
    else:
        mask = mask.astype(bool)
    markers = markers.astype(jnp.int32)
    seeded = (markers > 0) & mask
    labels0 = jnp.where(seeded, markers, 0)
    cost0 = jnp.where(seeded, surf, _BIG)
    shifts = _neighbor_shifts(surf.ndim, connectivity)

    def body(state):
        labels, cost, _, it = state
        best_cost = cost
        best_label = labels
        for off in shifts:
            nb_cost = shifted(cost, off, _BIG)
            nb_label = shifted(labels, off, 0)
            cand = jnp.maximum(nb_cost, surf)
            valid = nb_label > 0
            # Strictly-better only: on cost ties the incumbent keeps the
            # pixel, so plateaus are split by arrival order (one propagation
            # step per iteration ~ geodesic distance), matching the FIFO
            # flooding order of queue-based watershed implementations.
            better = valid & (
                (cand < best_cost) | ((cand == best_cost) & (best_label == 0))
            )
            best_cost = jnp.where(better, cand, best_cost)
            best_label = jnp.where(better, nb_label, best_label)
        # Seeds keep their identity; outside-mask pixels stay background.
        new_labels = jnp.where(seeded, markers, jnp.where(mask, best_label, 0))
        new_cost = jnp.where(seeded, surf, jnp.where(mask, best_cost, _BIG))
        changed = jnp.any(new_labels != labels) | jnp.any(new_cost != cost)
        return new_labels, new_cost, changed, it + 1

    def cond(state):
        return state[2] & (state[3] < max_iters)

    labels, _, _, _ = jax.lax.while_loop(
        cond, body, (labels0, cost0, jnp.bool_(True), jnp.int32(0))
    )
    return labels
