"""Per-laser-block spectral distances as batched matmuls.

The reference defines ~12 numba-JIT scalar metrics (channel_cosine_intensity
and variants, hiprfish_imaging_train_reference.py:223-1387) that UMAP calls
pairwise — O(N^2) scalar kernel invocations. Here the whole (N, M) distance
matrix is computed at once: each laser block's cosine similarity is
one normalized matmul, the check-bit gate is an element-wise select on
the result, so the entire custom metric is a handful of GEMMs + fused
element-wise ops.

Semantics reproduced (channel_cosine_intensity, train_reference.py:223-386):
  * per block b: cos_dist_b = 1 - <x_b, y_b>/(|x_b||y_b|); 0 if both zero,
    1 if exactly one is zero.
  * if the check-bit vectors of x and y agree (sum |diff| < 0.01): blocks
    whose check bit is OFF in x contribute 0; else all blocks contribute.
  * distance = mean over blocks.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

# Every distance dot runs in full f32: at the backend's default precision an
# f32 dot may run in TF32 (~3 decimal digits), enough to reorder near-tied
# neighbours and flip a kNN barcode call.
_PREC = jax.lax.Precision.HIGHEST


def _block_cosine_dist(xb: jax.Array, yb: jax.Array) -> jax.Array:
    """(N, M) cosine distances between block slices, with the reference's
    zero-norm conventions."""
    nx = jnp.sqrt(jnp.sum(xb * xb, axis=1))
    ny = jnp.sqrt(jnp.sum(yb * yb, axis=1))
    dots = jnp.dot(xb, yb.T, preferred_element_type=jnp.float32,
                   precision=_PREC)
    denom = nx[:, None] * ny[None, :]
    cos = jnp.where(denom > 0, dots / jnp.maximum(denom, 1e-30), 0.0)
    dist = 1.0 - cos
    both_zero = (nx[:, None] == 0) & (ny[None, :] == 0)
    one_zero = (nx[:, None] == 0) ^ (ny[None, :] == 0)
    dist = jnp.where(both_zero, 0.0, dist)
    dist = jnp.where(one_zero, 1.0, dist)
    return dist


def _block_normalize(a: jax.Array, blocks):
    """Per-block L2-normalized copy + (N, B) zero-norm indicators."""
    outs, zs = [], []
    for lo, hi in blocks:
        b = a[:, lo:hi]
        n = jnp.sqrt(jnp.sum(b * b, axis=1, keepdims=True))
        outs.append(jnp.where(n > 0, b / jnp.maximum(n, 1e-30), 0.0))
        zs.append(n[:, 0] == 0)
    return jnp.concatenate(outs, axis=1), jnp.stack(zs, axis=1).astype(
        jnp.float32)


@functools.partial(jax.jit, static_argnums=(2, 3))
def block_cosine_distance_matrix(
    x: jax.Array,
    y: jax.Array,
    blocks: Tuple[Tuple[int, int], ...],
    check_slice: Tuple[int, int] | None = None,
) -> jax.Array:
    """Pairwise gated block-cosine distances.

    Args:
      x: (N, D) query features (channels + check bits).
      y: (M, D) reference features.
      blocks: static ((lo, hi), ...) channel slices per laser block.
      check_slice: static (lo, hi) of the check-bit columns, or None for the
        ungated mean-of-block-cosines metric.

    Returns (N, M) float32 distances.

    Formulation: with rows normalized PER BLOCK up front, the sum of block
    cosines is ONE concatenated GEMM — sum_b <x̂_b, ŷ_b> = <x̂, ŷ> — and the
    zero-norm conventions become indicator GEMMs: a zero block normalizes
    to 0 (contributing cos 0, i.e. distance 1, the one-zero rule), and the
    both-zero rule (distance 0) subtracts the (N, M) both-zero block count
    z_x @ z_y^T. The old per-block form materialized 7 (N, M) distance
    temporaries plus ~20 (N, M) elementwise passes; this form is 2 wide
    GEMMs + 3 thin ones + one select.
    """
    x = x.astype(jnp.float32)
    y = y.astype(jnp.float32)
    n_blocks = len(blocks)
    xn, xz = _block_normalize(x, blocks)
    yn, yz = _block_normalize(y, blocks)
    dot = functools.partial(jax.lax.dot_general,
                            dimension_numbers=(((1,), (1,)), ((), ())),
                            preferred_element_type=jnp.float32,
                            precision=_PREC)
    cos_sum = dot(xn, yn)                   # sum_b cos_b ((N, M), one GEMM)
    n_both_zero = dot(xz, yz)               # both-zero blocks per pair
    ungated = (n_blocks - cos_sum - n_both_zero) / n_blocks
    if check_slice is None:
        return ungated
    clo, chi = check_slice
    xc = x[:, clo:chi]
    yc = y[:, clo:chi]
    # checks agree when sum |xc - yc| < 0.01 (train_reference.py:225).
    # For 0/1 bits, sum|x-y| = sum x + sum y - 2 x.y — one GEMM instead of
    # materializing the (N, M, n_checks) broadcast.
    diff = (
        jnp.sum(xc, axis=1)[:, None]
        + jnp.sum(yc, axis=1)[None, :]
        - 2.0 * dot(xc, yc)
    )
    agree = jnp.abs(diff) < 0.01
    n_checks = chi - clo
    gates = jnp.stack([xc[:, min(b, n_checks - 1)]
                       for b in range(n_blocks)], axis=1)   # (N, B)
    # scale each query block by its gate -> one GEMM gives sum_b g_b cos_b
    parts = []
    col = 0
    for b, (lo, hi) in enumerate(blocks):
        wid = hi - lo
        parts.append(xn[:, col:col + wid] * gates[:, b][:, None])
        col += wid
    xng = jnp.concatenate(parts, axis=1)
    g_cos = dot(xng, yn)
    g_both_zero = dot(xz * gates, yz)
    g_sum = jnp.sum(gates, axis=1)[:, None]
    gated = (g_sum - g_cos - g_both_zero) / n_blocks
    return jnp.where(agree, gated, ungated)


@functools.partial(jax.jit, static_argnums=(2,))
def block_chi_distance_matrix(
    x: jax.Array, y: jax.Array, blocks: Tuple[Tuple[int, int], ...]
) -> jax.Array:
    """Pairwise chi-square block distance (channel_chi_intensity_7b,
    train_reference.py:1168): per block, sum (x-y)^2/(x+y), averaged."""
    x = x.astype(jnp.float32)
    y = y.astype(jnp.float32)
    out = 0.0
    for lo, hi in blocks:
        xb = x[:, None, lo:hi]
        yb = y[None, :, lo:hi]
        num = (xb - yb) ** 2
        den = jnp.maximum(xb + yb, 1e-12)
        out = out + jnp.sum(num / den, axis=-1)
    return out / len(blocks)


@jax.jit
def correlation_distance_matrix(x: jax.Array, y: jax.Array) -> jax.Array:
    """Pairwise 1 - Pearson correlation (channel_correlation,
    train_reference.py:1275), as one centered-normalized matmul."""
    x = x.astype(jnp.float32)
    y = y.astype(jnp.float32)
    xc = x - jnp.mean(x, axis=1, keepdims=True)
    yc = y - jnp.mean(y, axis=1, keepdims=True)
    xn = xc / jnp.maximum(jnp.linalg.norm(xc, axis=1, keepdims=True), 1e-30)
    yn = yc / jnp.maximum(jnp.linalg.norm(yc, axis=1, keepdims=True), 1e-30)
    return 1.0 - jnp.dot(xn, yn.T, preferred_element_type=jnp.float32,
                         precision=_PREC)


# ---------------------------------------------------------------------------
# Exact matrix forms of the reference's pickled UMAP metrics
# ---------------------------------------------------------------------------

_REF_BLOCKS_10B = ((0, 32), (32, 55), (55, 75), (75, 89), (89, 95))
_REF_BLOCKS_7B = ((0, 23), (23, 43), (43, 57), (57, 63))


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _ref_gated_cosine_matrix(x, y, blocks, check_slice, gate_bits,
                             scale, disagree_mode):
    """Matrix transcription of the reference's scalar numba metrics
    (train_reference.py:224-1056), preserving each variant's exact branch
    structure:

      * pairs whose check-bit vectors agree (sum|diff| < 0.01) contribute the
        per-block cosine distances, with block b zeroed when x's gate bit
        ``gate_bits[b]`` is 0 (gate_bits[b] is None for ungated blocks);
      * disagreeing pairs get ``disagree_mode``:
          - "one": constant 1.0 (the *_7b / *_v2 family, :990/:1071);
          - "ungated_deriv1": ungated block distances plus a constant 1.0
            derivative term, averaged over n_blocks+1
            (channel_cosine_intensity_violet_derivative_v2, :663-731 — the
            [95:126] derivative slice itself is never read by the metric);
      * the mean is scaled by ``scale`` (0.5 for the *_v2 7-bit variants).
    """
    x = x.astype(jnp.float32)
    y = y.astype(jnp.float32)
    dists = [
        _block_cosine_dist(x[:, lo:hi], y[:, lo:hi]) for (lo, hi) in blocks
    ]
    clo, chi = check_slice
    xc = x[:, clo:chi]
    yc = y[:, clo:chi]
    diff = (
        jnp.sum(xc, axis=1)[:, None]
        + jnp.sum(yc, axis=1)[None, :]
        - 2.0 * jnp.dot(xc, yc.T, preferred_element_type=jnp.float32,
                        precision=_PREC)
    )
    agree = jnp.abs(diff) < 0.01
    gated = sum(
        d if g is None else d * xc[:, g][:, None]
        for d, g in zip(dists, gate_bits)
    )
    if disagree_mode == "ungated_deriv1":
        # derivative term: 0 on agreement, 1 on disagreement; /(n_blocks+1)
        n = len(blocks) + 1
        agree_val = gated / n
        disagree_val = (sum(dists) + 1.0) / n
    else:  # "one"
        agree_val = gated / len(blocks)
        disagree_val = jnp.float32(1.0)
    # the reference's 0.5 factor scales only the agree branch
    # (train_reference.py:1067: cos_dist = 0.5*(...)/4; else: cos_dist = 1)
    return jnp.where(agree, scale * agree_val, disagree_val)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _ref_chi_matrix(x, y, check_slice, denom):
    """channel_chi_intensity_7b (train_reference.py:1169): chi-square over
    the raw channels / 63, gated to 1.0 on check disagreement."""
    x = x.astype(jnp.float32)
    y = y.astype(jnp.float32)
    clo, chi = check_slice
    xb = x[:, None, :clo]
    yb = y[None, :, :clo]
    d = jnp.sum((xb - yb) ** 2 / jnp.maximum(xb + yb, 1e-30), axis=-1) / denom
    xc, yc = x[:, clo:chi], y[:, clo:chi]
    diff = (jnp.sum(xc, axis=1)[:, None] + jnp.sum(yc, axis=1)[None, :]
            - 2.0 * jnp.dot(xc, yc.T, preferred_element_type=jnp.float32,
                        precision=_PREC))
    return jnp.where(jnp.abs(diff) < 0.01, d, 1.0)


def reference_metric_matrix(name: str):
    """distance_fn(q, train) -> (Q, N) matching the reference numba metric
    recorded in a pickled UMAP artifact, for every metric the reference
    actually fits UMAPs with (train_reference.py:1415/1457/1511/1671/2109).

    Raises KeyError for unknown names — silently substituting euclidean for
    a gated spectral metric reorders neighbors and corrupts barcode calls.
    """
    B10, B7 = _REF_BLOCKS_10B, _REF_BLOCKS_7B
    table = {
        # :224 — blocks 1-3 gated by x[95..97], blocks 4-5 ungated; the
        # disagree branch leaves cos_dist undefined (a latent reference bug,
        # :386) — resolved to the family's consistent value, 1.0.
        "channel_cosine_intensity": lambda q, r: _ref_gated_cosine_matrix(
            q, r, B10, (95, 100), (0, 1, 2, None, None), 1.0, "one"),
        # :569 — all 5 blocks gated by x[126..130]; 6-bit check [126:132];
        # the derivative block's term is 0/1 by agreement, mean over 6.
        "channel_cosine_intensity_violet_derivative_v2":
            lambda q, r: _ref_gated_cosine_matrix(
                q, r, B10, (126, 132), (0, 1, 2, 3, 4), 1.0,
                "ungated_deriv1"),
        # :913 — 4 gated blocks, /4, disagree -> 1.
        "channel_cosine_intensity_7b": lambda q, r: _ref_gated_cosine_matrix(
            q, r, B7, (63, 67), (0, 1, 2, 3), 1.0, "one"),
        # :994 — same with a 0.5 scale, so agreeing pairs always beat
        # disagreeing ones.
        "channel_cosine_intensity_7b_v2":
            lambda q, r: _ref_gated_cosine_matrix(
                q, r, B7, (63, 67), (0, 1, 2, 3), 0.5, "one"),
        # :1181 — ungated mean of the 5 block cosines (no check columns).
        "channel_cosine_intensity_normal":
            lambda q, r: block_cosine_distance_matrix(q, r, B10, None),
        # :1169 — chi-square over 63 channels, check-gated.
        "channel_chi_intensity_7b":
            lambda q, r: _ref_chi_matrix(q, r, (63, 67), 63.0),
        # :1276 — plain Pearson correlation distance.
        "channel_correlation": correlation_distance_matrix,
    }
    return table[name]


def metric_for_layout(layout, violet_derivative: bool = False):
    """(blocks, check_slice) for the gated metric of a channel layout.

    10-bit + violet derivative: 6 blocks ([0:32],[32:55],[55:75],[75:89],
    [89:95],[95:126]) with checks at [126:132]
    (image_classification.py:47-54). 7-bit: 4 blocks with checks at [63:67]
    (classify_spectra.py:28-33)."""
    blocks = list(layout.blocks)
    c = layout.n_channels
    if violet_derivative:
        first = layout.blocks[0]
        d = first[1] - first[0] - 1  # np.diff width of the first block
        blocks = blocks + [(c, c + d)]
        c = c + d
    # One check column per metric block: without the violet-derivative block
    # the 10-bit layout has 5 blocks and uses 5 checks (c1..c5,
    # train_reference.py:1408-1412); the 6th check bit exists only for the
    # derivative block (image_classification.py:54).
    n_checks = min(len(layout.check_bit_groups), len(blocks))
    return tuple(blocks), (c, c + n_checks)
