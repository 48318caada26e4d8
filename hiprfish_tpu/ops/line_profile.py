"""Line-profile (LP-CV) edge-enhancement stencil.

The reference computes, for every pixel/voxel, intensity profiles along a set
of line orientations through the pixel, min-max normalizes each profile, takes
the center sample, and combines the per-orientation values into an
edge-enhanced scalar: mean over orientations x (1 - quartile CV). This drives
all watershed seeding (reference: neighbor2d.pyx:8-64 [2D],
neighbor.pyx:115-349 [3D]; enhancement math:
hiprfish_imaging_multispecies_spectral_image_measurement.py:110-124).

Design
------
The stencil is a *fixed* sparse gather: for orientation t and sample s the
source offset is a compile-time constant. So instead of a per-pixel scalar
loop (the Cython design), each (t, s) pair becomes one statically-shifted view
of the padded image, and the whole enhancement is a tree of fused element-wise
min/max/add ops over those views — no (H, W, T, S) intermediate is ever
materialized in the fused path. XLA fuses the ~T*S slices into a handful of
device-memory passes.

All functions are pure and jit-safe; tables are built in numpy at trace time.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Offset tables
# ---------------------------------------------------------------------------


def _line_coords_1axis(interval: int, line_n: int, li: int, increment: int) -> int:
    """Patch coordinate along one axis for sample ``li`` of a line.

    Re-derivation of the coordinate rule in neighbor2d.pyx:42-45: sample
    positions step by (2*|interval|+1)/line_n along each axis with the sign of
    the axis interval, anchored so the line passes through the patch center.
    """
    sign = int(np.sign(interval))
    h = sign * li * (2 * abs(interval) + 1) / line_n
    return int(np.sign(h) * np.floor(abs(h)) + increment - interval)


def line_table_2d(patch_size: int = 11, phi_range: int = 9) -> np.ndarray:
    """Integer patch coordinates for the 2D stencil.

    Returns int array of shape (phi_range, patch_size, 2): for orientation phi
    and sample li, the (row, col) coordinate within a (patch_size, patch_size)
    patch. Matches the table built by neighbor2d.pyx:32-55.
    """
    increment = (patch_size - 1) // 2
    table = np.zeros((phi_range, patch_size, 2), dtype=np.int64)
    for phi in range(phi_range):
        ivals = np.array(
            [
                int(np.round(increment * np.cos(phi * np.pi / phi_range))),
                int(np.round(increment * np.sin(phi * np.pi / phi_range))),
            ]
        )
        max_interval = ivals[np.argmax(np.abs(ivals))]
        line_n = int(2 * abs(max_interval) + 1)
        if line_n < patch_size:
            diff = (patch_size - line_n) // 2
            for li in range(line_n):
                for a in range(2):
                    table[phi, li + diff, a] = _line_coords_1axis(
                        ivals[a], line_n, li, increment
                    )
            table[phi, :diff] = table[phi, diff]
            table[phi, line_n + diff :] = table[phi, line_n + diff - 1]
        else:
            for li in range(line_n):
                for a in range(2):
                    table[phi, li, a] = _line_coords_1axis(ivals[a], line_n, li, increment)
    return table


def line_table_3d(
    patch_size: int = 11, theta_range: int = 9, phi_range: int = 9
) -> np.ndarray:
    """Integer patch coordinates for the 3D stencil.

    Shape ((theta_range-1)*phi_range, patch_size, 3). Matches
    neighbor.pyx:141-170 (line_profile_v2 / _memory_efficient_v2).
    """
    increment = (patch_size - 1) // 2
    n_orient = (theta_range - 1) * phi_range
    table = np.zeros((n_orient, patch_size, 3), dtype=np.int64)
    for theta in range(1, theta_range):
        for phi in range(phi_range):
            t = (theta - 1) * phi_range + phi
            ivals = np.array(
                [
                    int(
                        np.round(
                            increment
                            * np.cos(phi * np.pi / phi_range)
                            * np.sin(theta * np.pi / theta_range)
                        )
                    ),
                    int(
                        np.round(
                            increment
                            * np.sin(phi * np.pi / phi_range)
                            * np.sin(theta * np.pi / theta_range)
                        )
                    ),
                    int(np.round(increment * np.cos(theta * np.pi / theta_range))),
                ]
            )
            max_interval = ivals[np.argmax(np.abs(ivals))]
            line_n = int(2 * abs(max_interval) + 1)
            if line_n < patch_size:
                diff = (patch_size - line_n) // 2
                for li in range(line_n):
                    for a in range(3):
                        table[t, li + diff, a] = _line_coords_1axis(
                            ivals[a], line_n, li, increment
                        )
                table[t, :diff] = table[t, diff]
                table[t, line_n + diff :] = table[t, line_n + diff - 1]
            else:
                for li in range(line_n):
                    for a in range(3):
                        table[t, li, a] = _line_coords_1axis(
                            ivals[a], line_n, li, increment
                        )
    return table


# ---------------------------------------------------------------------------
# Full-profile gathers (API parity with the Cython kernels; used by oracles)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(1, 2))
def line_profile_2d(image_padded: jax.Array, patch_size: int = 11, phi_range: int = 9):
    """All line profiles of a padded 2D image.

    Equivalent to neighbor2d.pyx:line_profile_2d_v2: input (H+p-1, W+p-1)
    edge-padded image, output (H, W, phi_range, patch_size).
    """
    table = line_table_2d(patch_size, phi_range)
    hp, wp = image_padded.shape
    h, w = hp - (patch_size - 1), wp - (patch_size - 1)
    views = []
    for t in range(phi_range):
        per_t = []
        for li in range(patch_size):
            di, dj = int(table[t, li, 0]), int(table[t, li, 1])
            per_t.append(jax.lax.slice(image_padded, (di, dj), (di + h, dj + w)))
        views.append(jnp.stack(per_t, axis=-1))
    return jnp.stack(views, axis=2)


def _rnc_3d(volume_padded: jax.Array, patch_size: int, theta_range: int,
            phi_range: int) -> jax.Array:
    """(n_orient, X, Y, Z) per-orientation min-max-normalized center
    samples of a padded volume (orientation axis leading).

    The 72 orientations x 11 samples are walked with lax.scan +
    dynamic_slice (rather than 792 unrolled slices) to keep the compiled
    graph small; each scan step is a fused shift/min/max pass.
    """
    table = jnp.asarray(line_table_3d(patch_size, theta_range, phi_range), jnp.int32)
    xp, yp, zp = volume_padded.shape
    x = xp - (patch_size - 1)
    y = yp - (patch_size - 1)
    z = zp - (patch_size - 1)
    center = (patch_size - 1) // 2
    # The scan is memory-bound (72 orientations x 11 samples, each a
    # shifted read + two accumulator updates); min/max selection commutes
    # with monotone rounding, so accumulating in the caller-chosen dtype
    # (bf16 where the platform policy says so) halves the traffic. The rnc
    # ratio is formed in f32.
    vol = volume_padded
    acc_dtype = vol.dtype if vol.dtype == jnp.bfloat16 else jnp.float32
    vol = vol.astype(acc_dtype)

    def per_orientation(_, coords):  # coords: (patch_size, 3)
        def per_sample(carry, c):
            vmin, vmax = carry
            v = jax.lax.dynamic_slice(vol, (c[0], c[1], c[2]), (x, y, z))
            return (jnp.minimum(vmin, v), jnp.maximum(vmax, v)), None

        init = (
            jnp.full((x, y, z), jnp.inf, acc_dtype),
            jnp.full((x, y, z), -jnp.inf, acc_dtype),
        )
        (vmin, vmax), _ = jax.lax.scan(per_sample, init, coords)
        c = coords[center]
        vcen = jax.lax.dynamic_slice(vol, (c[0], c[1], c[2]), (x, y, z))
        rnc = (vcen.astype(jnp.float32) - vmin.astype(jnp.float32)) / \
            jnp.maximum(vmax.astype(jnp.float32) - vmin.astype(jnp.float32),
                        1e-8)
        return None, rnc

    _, rncs = jax.lax.scan(per_orientation, None, table)
    return rncs


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def line_profile_3d(
    volume_padded: jax.Array,
    patch_size: int = 11,
    theta_range: int = 9,
    phi_range: int = 9,
):
    """Center-normalized 3D line profiles.

    Equivalent to neighbor.pyx:line_profile_memory_efficient_v2: input
    (X+p-1, Y+p-1, Z+p-1) padded volume, output (X, Y, Z, n_orient) of
    per-orientation min-max-normalized center samples.
    """
    return jnp.moveaxis(
        _rnc_3d(volume_padded, patch_size, theta_range, phi_range), 0, -1)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def line_profile_3d_full(
    volume_padded: jax.Array,
    patch_size: int = 11,
    theta_range: int = 9,
    phi_range: int = 9,
):
    """Raw (X, Y, Z, n_orient, patch_size) 3D line profiles — API parity with
    neighbor.pyx:line_profile_v2 (the memory-hungry variant used by the
    reference's tiled 3D path, biofilm_analysis.py:904). Only sensible on
    small chunks; the fused lp_cv_enhance_3d is the production path."""
    table = jnp.asarray(line_table_3d(patch_size, theta_range, phi_range),
                        jnp.int32)
    xp, yp, zp = volume_padded.shape
    x = xp - (patch_size - 1)
    y = yp - (patch_size - 1)
    z = zp - (patch_size - 1)
    vol = volume_padded.astype(jnp.float32)

    def per_coord(c):
        return jax.lax.dynamic_slice(vol, (c[0], c[1], c[2]), (x, y, z))

    def per_orientation(coords):  # (patch_size, 3)
        return jax.vmap(per_coord)(coords)  # (patch_size, x, y, z)

    prof = jax.lax.map(per_orientation, table)  # (T, S, x, y, z)
    return jnp.moveaxis(prof, (0, 1), (3, 4))


@functools.partial(jax.jit, static_argnums=(1,))
def neighbor_average(volume_padded: jax.Array, patch_size: int = 11):
    """Multi-scale 3D box means around each voxel: (X, Y, Z, patch_size-1)
    where slot s-1 is the mean over the (2s+1)^3 cube — parity with
    neighbor.pyx:neighbor_average:8-37 (defined but unused by the reference;
    provided for API completeness). Computed with separable cumulative sums
    instead of the Cython 7-deep loop nest."""
    pad_total = 2 * (patch_size - 1)
    x = volume_padded.shape[0] - pad_total
    y = volume_padded.shape[1] - pad_total
    z = volume_padded.shape[2] - pad_total
    vol = volume_padded.astype(jnp.float32)
    # Integral volume with a leading zero plane per axis.
    c = vol
    for ax in range(3):
        c = jnp.cumsum(c, axis=ax)
        c = jnp.pad(c, [(1, 0) if a == ax else (0, 0) for a in range(3)])

    def box_sum(lo, size):
        """Sum over [lo, lo+size)^3 windows for every output voxel."""
        def take(dx, dy, dz):
            return jax.lax.slice(
                c,
                (lo + dx * size, lo + dy * size, lo + dz * size),
                (lo + dx * size + x, lo + dy * size + y, lo + dz * size + z),
            )

        s = take(1, 1, 1) - take(0, 1, 1) - take(1, 0, 1) - take(1, 1, 0)
        s = s + take(0, 0, 1) + take(0, 1, 0) + take(1, 0, 0) - take(0, 0, 0)
        return s

    outs = []
    center = patch_size - 1  # offset of the output voxel in the padded frame
    for s in range(1, patch_size):
        size = 2 * s + 1
        lo = center - s
        outs.append(box_sum(lo, size) / (size ** 3))
    return jnp.stack(outs, axis=-1)


# ---------------------------------------------------------------------------
# Fused LP-CV enhancement (the production path)
# ---------------------------------------------------------------------------


def _quartile_ranks(t: int):
    """((lo, hi, frac) of the 25th, same of the 75th) percentile of t
    values with linear interpolation (np.percentile's default)."""
    q25, q75 = 0.25 * (t - 1), 0.75 * (t - 1)
    lo25, hi25 = int(np.floor(q25)), int(np.ceil(q25))
    lo75, hi75 = int(np.floor(q75)), int(np.ceil(q75))
    return (lo25, hi25, q25 - lo25), (lo75, hi75, q75 - lo75)


def _quartiles_small(values, q25_rank: float, q75_rank: float):
    """25th/75th percentiles along the last axis with linear interpolation.

    ``values`` has a small static last axis (9 or 72 orientations).
    """
    s = jnp.sort(values, axis=-1)
    lo25, hi25 = int(np.floor(q25_rank)), int(np.ceil(q25_rank))
    lo75, hi75 = int(np.floor(q75_rank)), int(np.ceil(q75_rank))
    f25 = q25_rank - lo25
    f75 = q75_rank - lo75
    lq = s[..., lo25] * (1 - f25) + s[..., hi25] * f25
    uq = s[..., lo75] * (1 - f75) + s[..., hi75] * f75
    return lq, uq


@functools.lru_cache(maxsize=None)
def _batcher_comparators(n: int):
    """Batcher odd-even mergesort comparator list (ascending) for n inputs.

    Generated for the next power of two; with +inf padding at the top,
    every comparator touching an index >= n is a no-op and is dropped.
    """
    p2 = 1
    while p2 < n:
        p2 *= 2
    comps = []
    p = 1
    while p < p2:
        k = p
        while k >= 1:
            for j in range(k % p, p2 - k, 2 * k):
                for i in range(0, k):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        a, b = i + j, i + j + k
                        if b < n:
                            comps.append((a, b))
            k //= 2
        p *= 2
    return tuple(comps)


@functools.lru_cache(maxsize=None)
def selection_network(n: int, outputs: tuple):
    """Comparators (a, b) whose removal could change the given output
    ranks — backward prune of the full Batcher network. Applying them in
    order leaves the k-th smallest at index k for every k in ``outputs``."""
    needed = set(outputs)
    kept = []
    for (a, b) in reversed(_batcher_comparators(n)):
        if a in needed or b in needed:
            kept.append((a, b))
            needed.add(a)
            needed.add(b)
    return tuple(reversed(kept))


def _lp_cv_combine_network(rncs: jax.Array) -> jax.Array:
    """_lp_cv_combine over a LEADING orientation axis (T, ...), with the
    quartiles from a selection network pruned to the four order statistics
    the interpolation reads: pure elementwise min/max, so no sort and no
    move of the orientation axis to the minor dimension."""
    t = rncs.shape[0]
    (lo25, hi25, f25), (lo75, hi75, f75) = _quartile_ranks(t)
    vals = [rncs[o] for o in range(t)]
    for a, b in selection_network(t, (lo25, hi25, lo75, hi75)):
        vals[a], vals[b] = (jnp.minimum(vals[a], vals[b]),
                            jnp.maximum(vals[a], vals[b]))
    lq = vals[lo25] * (1 - f25) + vals[hi25] * f25
    uq = vals[lo75] * (1 - f75) + vals[hi75] * f75
    qcv = jnp.where(uq > 0, (uq - lq) / (uq + lq + 1e-8), 0.0)
    return jnp.mean(rncs, axis=0) * (1.0 - qcv)


def _lp_cv_combine(rnc_stack: jax.Array) -> jax.Array:
    """Combine per-orientation normalized center samples (..., T) into the
    LP-CV enhanced scalar: mean(rnc) * (1 - quartile CV).

    Math from hiprfish_imaging_multispecies_spectral_image_measurement.py:118-124.
    """
    t = rnc_stack.shape[-1]
    mean = jnp.mean(rnc_stack, axis=-1)
    lq, uq = _quartiles_small(rnc_stack, 0.25 * (t - 1), 0.75 * (t - 1))
    qcv = jnp.where(uq > 0, (uq - lq) / (uq + lq + 1e-8), 0.0)
    return mean * (1.0 - qcv)


@functools.partial(jax.jit, static_argnums=(1, 2))
def lp_cv_enhance_2d(image: jax.Array, patch_size: int = 11, phi_range: int = 9):
    """Fused 2D LP-CV edge enhancement of an (H, W) image.

    Equivalent to: edge-pad by (patch_size-1)//2, line_profile_2d, per-profile
    min-max normalize, take center sample, mean over angles x (1 - quartile CV)
    — the whole segmentation-enhancement chain of
    multispecies_spectral_image_measurement.py:109-124 — without materializing
    the (H, W, T, S) profile tensor.
    """
    pad = (patch_size - 1) // 2
    padded = jnp.pad(image, pad, mode="edge")
    table = line_table_2d(patch_size, phi_range)
    h, w = image.shape
    center = pad
    rnc = []
    for t in range(phi_range):
        vmin = None
        vmax = None
        vcenter = None
        for li in range(patch_size):
            di, dj = int(table[t, li, 0]), int(table[t, li, 1])
            v = jax.lax.slice(padded, (di, dj), (di + h, dj + w))
            vmin = v if vmin is None else jnp.minimum(vmin, v)
            vmax = v if vmax is None else jnp.maximum(vmax, v)
            if li == center:
                vcenter = v
        rng = jnp.maximum(vmax - vmin, 1e-8)
        rnc.append((vcenter - vmin) / rng)
    return _lp_cv_combine(jnp.stack(rnc, axis=-1))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def lp_cv_enhance_3d(
    volume: jax.Array,
    patch_size: int = 11,
    theta_range: int = 9,
    phi_range: int = 9,
):
    """Fused 3D LP-CV enhancement of an (X, Y, Z) volume.

    The fused equivalent of line_profile_memory_efficient_v2 followed by the
    enhancement math of hiprfish_imaging_biofilm_analysis.py:456-462.
    """
    pad = (patch_size - 1) // 2
    padded = jnp.pad(volume, pad, mode="edge")
    rnc = line_profile_3d(padded, patch_size, theta_range, phi_range)
    return _lp_cv_combine(rnc)
