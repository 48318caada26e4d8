"""Device-side synthetic 3D biofilm volume generator.

Full-scale 3D validation needs reference-sized volumes (2020x2020x170,
biofilm_analysis.py:1088) with known per-cell barcodes. Materializing the
63-channel spectral volume is ~175 GB, and host->device staging of even the
summed volume is slow — so everything here is *analytic and chunked*: cells
sit on a jittered 3D grid with geometry derived from an integer hash of
their grid node, so any z-chunk of the truth labels, the channel-summed
intensity, or the per-channel spectral data can be generated directly on
device in O(voxels) with no scatter and no host traffic. The jitter and
semi-axis bounds guarantee a voxel can only ever be inside the cell of its
own grid node, which makes the membership test O(1) per voxel.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class VolumeSpec:
    """Geometry of a synthetic cell volume."""

    shape: tuple          # (X, Y, Z)
    spacing: tuple = (36, 36, 52)   # grid pitch per axis
    jitter: tuple = (4.0, 4.0, 4.0)
    semi_axes_lo: tuple = (11.0, 7.0, 8.0)   # (major-xy, minor-xy, z)
    semi_axes_hi: tuple = (14.0, 9.0, 11.0)
    noise: float = 0.03
    brightness_lo: float = 0.8
    brightness_hi: float = 1.2
    seed: int = 0

    @property
    def grid(self):
        return tuple(s // p for s, p in zip(self.shape, self.spacing))

    @property
    def n_cells(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz


def _hash_u32(ix, iy, iz, salt):
    """Cheap per-node integer hash -> uint32 (splitmix-style mixing)."""
    h = (ix.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
         ^ iy.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B)
         ^ iz.astype(jnp.uint32) * jnp.uint32(0xC2B2AE35)
         ^ jnp.uint32(salt))
    h = (h ^ (h >> 16)) * jnp.uint32(0x7FEB352D)
    h = (h ^ (h >> 15)) * jnp.uint32(0x846CA68B)
    return h ^ (h >> 16)


def _unit(ix, iy, iz, salt):
    """Per-node uniform float in [0, 1)."""
    return _hash_u32(ix, iy, iz, salt).astype(jnp.float32) / jnp.float32(2**32)


def node_codes(spec: VolumeSpec, n_codes: int) -> np.ndarray:
    """(n_cells,) barcode-index per grid node (row-major node order);
    deterministic counterpart of the per-voxel device computation."""
    gx, gy, gz = spec.grid
    ix, iy, iz = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz),
                             indexing="ij")

    def h(ix, iy, iz, salt):
        ix = ix.astype(np.uint32)
        iy = iy.astype(np.uint32)
        iz = iz.astype(np.uint32)
        v = (ix * np.uint32(0x9E3779B9) ^ iy * np.uint32(0x85EBCA6B)
             ^ iz * np.uint32(0xC2B2AE35) ^ np.uint32(salt))
        v = (v ^ (v >> np.uint32(16))) * np.uint32(0x7FEB352D)
        v = (v ^ (v >> np.uint32(15))) * np.uint32(0x846CA68B)
        return v ^ (v >> np.uint32(16))

    return (h(ix, iy, iz, spec.seed + 7) % np.uint32(n_codes)).reshape(-1)


@functools.partial(jax.jit, static_argnums=(0, 1, 3))
def truth_chunk(spec: VolumeSpec, n_codes: int, z0, zc: int):
    """(labels (X, Y, zc) int32 with 1-based node ids, code_idx int32,
    profile f32 in [0, 1]) for z-slab [z0, z0+zc)."""
    x, y, _ = spec.shape
    sx, sy, sz = spec.spacing
    gx, gy, gz = spec.grid
    xs = jnp.arange(x, dtype=jnp.float32)[:, None, None]
    ys = jnp.arange(y, dtype=jnp.float32)[None, :, None]
    zs = (jnp.arange(zc, dtype=jnp.float32) + z0)[None, None, :]

    ix = jnp.clip((xs // sx).astype(jnp.int32), 0, gx - 1)
    iy = jnp.clip((ys // sy).astype(jnp.int32), 0, gy - 1)
    iz = jnp.clip((zs // sz).astype(jnp.int32), 0, gz - 1)
    ix, iy, iz = jnp.broadcast_arrays(
        jnp.broadcast_to(ix, (x, 1, 1)).astype(jnp.int32),
        jnp.broadcast_to(iy, (1, y, 1)).astype(jnp.int32),
        jnp.broadcast_to(iz, (1, 1, zc)).astype(jnp.int32))

    def u(salt):
        return _unit(ix, iy, iz, spec.seed + salt)

    cx = (ix.astype(jnp.float32) + 0.5) * sx + (u(1) - 0.5) * 2 * spec.jitter[0]
    cy = (iy.astype(jnp.float32) + 0.5) * sy + (u(2) - 0.5) * 2 * spec.jitter[1]
    cz = (iz.astype(jnp.float32) + 0.5) * sz + (u(3) - 0.5) * 2 * spec.jitter[2]
    a = spec.semi_axes_lo[0] + u(4) * (spec.semi_axes_hi[0] - spec.semi_axes_lo[0])
    b = spec.semi_axes_lo[1] + u(5) * (spec.semi_axes_hi[1] - spec.semi_axes_lo[1])
    c = spec.semi_axes_lo[2] + u(6) * (spec.semi_axes_hi[2] - spec.semi_axes_lo[2])
    theta = u(7) * jnp.float32(np.pi)

    dx = xs - cx
    dy = ys - cy
    dz = zs - cz
    ct = jnp.cos(theta)
    st = jnp.sin(theta)
    uu = dx * ct + dy * st
    vv = -dx * st + dy * ct
    r2 = (uu / a) ** 2 + (vv / b) ** 2 + (dz / c) ** 2
    inside = r2 <= 1.0

    node_id = (ix * gy + iy) * gz + iz
    labels = jnp.where(inside, node_id + 1, 0).astype(jnp.int32)
    code_idx = (_hash_u32(ix, iy, iz, spec.seed + 7)
                % jnp.uint32(n_codes)).astype(jnp.int32)
    gain = spec.brightness_lo + u(8) * (spec.brightness_hi - spec.brightness_lo)
    profile = jnp.where(
        inside, (1.0 - 0.2 * jnp.sqrt(jnp.clip(r2, 0.0, 1.0))) * gain, 0.0)
    return labels, code_idx, profile.astype(jnp.float32)


@functools.partial(jax.jit, static_argnums=(0, 1, 3))
def sum_chunk(spec: VolumeSpec, n_codes: int, z0, zc: int,
              sum_lut: jax.Array, key: jax.Array):
    """Channel-summed intensity slab: profile * sum(spectrum of the cell's
    barcode) + uniform noise (matches utils/synthetic.make_fov's model)."""
    _, code_idx, profile = truth_chunk(spec, n_codes, z0, zc)
    base = profile * sum_lut[code_idx]
    noise = jax.random.uniform(jax.random.fold_in(key, z0),
                               base.shape, jnp.float32) * spec.noise
    return base + noise


@functools.partial(jax.jit, static_argnums=(0, 1, 3))
def channel_chunk(spec: VolumeSpec, n_codes: int, z0, zc: int,
                  spectra_lut: jax.Array, key: jax.Array):
    """(X, Y, zc, C) spectral slab: profile x barcode spectrum + noise."""
    _, code_idx, profile = truth_chunk(spec, n_codes, z0, zc)
    base = profile[..., None] * spectra_lut[code_idx]
    noise = jax.random.uniform(jax.random.fold_in(key, z0 + 100003),
                               base.shape, jnp.float32) * spec.noise
    return base + noise


@functools.partial(jax.jit, static_argnums=(0, 1, 3, 6))
def channel_chunk_cm(spec: VolumeSpec, n_codes: int, z0, zc: int,
                     spectra_lut: jax.Array, key: jax.Array,
                     dtype=jnp.float32):
    """(C, zc, X, Y) spectral slab — the channels-major layout the streamed
    measurement takes.

    ``dtype``: output storage dtype; bf16 halves the slab's write and the
    measurement's read (the per-cell sums accumulate in f32 downstream
    either way)."""
    _, code_idx, profile = truth_chunk(spec, n_codes, z0, zc)
    code_t = jnp.transpose(code_idx, (2, 0, 1))          # (zc, X, Y)
    prof_t = jnp.transpose(profile, (2, 0, 1))
    lut_t = jnp.transpose(jnp.asarray(spectra_lut))      # (C, n_codes)
    base = lut_t[:, code_t] * prof_t[None]               # (C, zc, X, Y)
    noise = jax.random.uniform(jax.random.fold_in(key, z0 + 100003),
                               base.shape, jnp.float32) * spec.noise
    return (base + noise).astype(dtype)


def build_sum_volume(spec: VolumeSpec, n_codes: int, sum_lut, seed: int = 0,
                     z_chunk: int = 32):
    """Assemble the full (X, Y, Z) channel-summed volume on device."""
    x, y, z = spec.shape
    key = jax.random.PRNGKey(seed)
    lut = jnp.asarray(sum_lut, jnp.float32)
    slabs = []
    for z0 in range(0, z, z_chunk):
        zc = min(z_chunk, z - z0)
        slabs.append(sum_chunk(spec, n_codes, z0, zc, lut, key))
    return jnp.concatenate(slabs, axis=2)
