"""Gather/scatter-free per-label statistics and relabeling.

The classic formulations of relabel_sequential / remove_small_objects /
per-cell measurement (counts scatter-add + table gather, regionprops loops in
the reference: spectral_image_measurement.py:153-155,
multispecies_spectral_image_measurement.py:155-157) are full-image scatters
and gathers. This module replaces them with three dense, matmul-shaped
primitives (designed where full-image gathers and scatters were the
dominant cost; whether they still win on the GPU is measured by
tools/kernel_bench.py):

  * rank_labels: sequential 1..n relabeling of a min-linear-index label image
    (what ops.labeling.label produces) with ZERO gathers: a label value v is
    present iff the pixel at linear index v-1 carries v (the component
    representative), so presence is elementwise; ranks are a cumsum; and the
    rank is flooded back over each component with the same segmented-scan
    machinery labeling uses.

  * label_stats: per-label [count, border_hits, channel sums] in ONE pass as
    band-windowed one-hot matmuls. Sequential ids ordered by component
    min-index are *band-local*: all ids occurring in a horizontal stripe of
    the image lie in a narrow contiguous range, so a (band_px, width) one-hot
    against a sliding id window turns the segment-sum into dense matmuls.

  * label_lookup: the inverse broadcast (per-pixel table value) with the same
    windowed one-hot trick — a gather-free remap.

Band-locality is a property of realistic images (components much smaller
than the image). Pathological inputs are detected (window spill / id
overflow flags) and the callers fall back to the exact scatter/gather path
via lax.cond, so results are always correct.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hiprfish_tpu.ops.labeling import _neighbor_shifts, shifted

# Python int, NOT a jnp array: a module-level device-array constant
# closed over by jitted code can be promoted to a hidden executable
# parameter at compile time, which the cached-call fastpath then fails
# to supply (measured: 'supplied 22 buffers but expected 23').
_INF = 2**30


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def rank_labels(labels: jax.Array, connectivity: int = 2,
                max_iters: int = 512, max_run: int | None = None):
    """Sequential 1..n relabel of a min-linear-index label image, no gathers.

    ``labels`` must come from ops.labeling.label (or any labeling where each
    component's id equals 1 + the linear index of its minimum pixel, and that
    pixel carries the id). Returns (seq_labels int32, n_labels int32). Rank
    order matches relabel_sequential (ascending original id = ascending
    min-index), so downstream CSV contracts are unchanged.
    """
    from hiprfish_tpu.ops.labeling import _run_min_scan, _window_pool

    ndim = labels.ndim
    mask = labels > 0
    size = labels.size
    lin = (jnp.arange(size, dtype=jnp.int32) + 1).reshape(labels.shape)
    rep = mask & (labels == lin)                      # component representative
    ranks_flat = jnp.cumsum(rep.reshape(-1).astype(jnp.int32))
    n = ranks_flat[-1]

    # DENSE min-flood formulation: at every masked pixel the running count
    # of representatives at its own position is >= its component's rank,
    # with equality exactly at the representative (the component's
    # min-index pixel) — so the rank image is the component-wise MIN of
    # this dense field. Distinct components are never within the
    # connectivity neighborhood of each other (else they would be one
    # component), so mask-gated propagation cannot mix ranks. The dense
    # field reuses label()'s min-flood machinery wholesale (the old sparse
    # rank0 max-flood was a second, mirrored implementation).
    dense0 = jnp.where(mask, ranks_flat.reshape(labels.shape), _INF)

    shifts = [s for s in _neighbor_shifts(ndim, connectivity)
              if sum(abs(o) for o in s) >= 2]
    full_conn = connectivity == ndim

    def body(state):
        r, _, it = state
        cur = r
        if full_conn:
            # separable 3^ndim min-pool == one full-neighborhood step
            # (see labeling._window_pool)
            cur = jnp.where(mask, _window_pool(cur, jnp.minimum, _INF),
                            _INF)
        else:
            nb = cur
            for off in shifts:
                nb = jnp.minimum(nb, shifted(cur, off, _INF))
            cur = jnp.where(mask, jnp.minimum(cur, nb), _INF)
        for axis in range(ndim):
            cur = _run_min_scan(cur, mask, axis, False, max_run)
            cur = _run_min_scan(cur, mask, axis, True, max_run)
        return cur, jnp.any(cur != r), it + 1

    def cond(state):
        return state[1] & (state[2] < max_iters)

    rank, _, _ = jax.lax.while_loop(
        cond, body, (dense0, jnp.bool_(True), jnp.int32(0)))
    return jnp.where(mask, rank, 0), n


class LabelStats(NamedTuple):
    counts: jax.Array        # (num_segments,) f32 pixel counts
    border_hits: jax.Array   # (num_segments,) f32 border-pixel counts
    sums: jax.Array          # (num_segments, C) per-channel sums (C may be 0)
    spill: jax.Array         # bool: window overflow -> caller must fall back
    moments: jax.Array | None = None   # (num_segments, 5) [r, c, r^2, c^2, rc]
    aux_hist: jax.Array | None = None  # (num_segments, A) aux-value histogram
    mask_counts: jax.Array | None = None  # (num_segments,) masked-pixel count


def _pick_band_px(size: int, nominal: int = 16384) -> int:
    """Largest divisor of ``size`` <= nominal (pad-free banding); falls back
    to ``nominal`` if size is awkward (callers then pay one pad copy)."""
    for b in range(nominal, max(nominal // 4, 1), -1):
        if size % b == 0:
            return b
    return nominal


def _band_setup(labels: jax.Array, band_px: int):
    """Flatten to padded (nb, band_px) bands."""
    n = labels.size
    nb = -(-n // band_px)
    pad = nb * band_px - n
    flat = labels.reshape(-1)
    if pad:
        flat = jnp.pad(flat, (0, pad))
    return flat.reshape(nb, band_px), n, nb, pad


def _window_onehot(lb: jax.Array, width: int, num_segments: int):
    """One-hot of in-window ids for one band.

    Returns (oh bf16, base, spilled). bf16 halves the HBM traffic of the
    materialized one-hot (the dominant cost) and 0/1 are exact in bf16; pair
    it with hi/lo-split f32 features for ~16-bit-accurate sums.
    """
    pos = jnp.where(lb > 0, lb, _INF)
    base = jnp.clip(jnp.min(pos), 0, num_segments - 1)
    loc = lb - base
    inw = (lb > 0) & (loc >= 0) & (loc < width)
    loc = jnp.where(inw, loc, 0)
    oh = (loc[:, None] == jnp.arange(width, dtype=jnp.int32)[None, :])
    dtype = jnp.bfloat16 if _use_bf16_dots() else jnp.float32
    oh = (oh & inw[:, None]).astype(dtype)
    spilled = jnp.any((lb > 0) & ~inw)
    return oh, base, spilled


def _use_bf16_dots() -> bool:
    """bf16 one-hot + hi/lo-split features (halves the dominant one-hot
    memory traffic; decided by utils/platform.policy)."""
    from hiprfish_tpu.utils.platform import policy

    return policy().bf16_dots


def _split_dot(oh: jax.Array, feat_f32: jax.Array):
    """(oh^T @ feat): exact for 0/1/integer columns, ~2^-16 relative error
    for general f32 columns on the bf16 path."""
    dn = (((0,), (0,)), ((), ()))
    if oh.dtype == jnp.bfloat16:
        # Two XLA rewrites silently destroy a naive hi/lo split (both
        # measured here): (1) allow-excess-precision elides the
        # f32->bf16->f32 convert pair, turning lo into exactly 0 — the
        # barrier between the converts blocks it; (2) the algebraic
        # simplifier merges dot(a, hi) + dot(a, lo) into dot(a, hi + lo)
        # with the sum rounded to bf16 — barriering the shared operand
        # makes the dots unmergeable (the one-hot is still materialized
        # only once).
        hi = jax.lax.optimization_barrier(feat_f32.astype(jnp.bfloat16))
        lo = (feat_f32 - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        oh2 = jax.lax.optimization_barrier(oh)
        part = jax.lax.dot_general(oh, hi, dn,
                                   preferred_element_type=jnp.float32)
        part += jax.lax.dot_general(oh2, lo, dn,
                                    preferred_element_type=jnp.float32)
        return part
    return jax.lax.dot_general(oh, feat_f32, dn,
                               precision=jax.lax.Precision.HIGHEST)


def _moment_cols(row_f, col_f):
    """[r, c, r^2, c^2, rc] columns (skimage central-moment ingredients)."""
    return jnp.stack([row_f, col_f, row_f * row_f, col_f * col_f,
                      row_f * col_f], axis=1)


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _label_stats_windowed(labels: jax.Array, image: jax.Array | None,
                          aux: jax.Array | None,
                          image_mask: jax.Array | None, num_segments: int,
                          width: int, band_px: int, aux_classes: int,
                          moments: bool):
    shape = labels.shape
    h, w = shape[0], int(labels.size // shape[0])
    lab_b, n, nb, pad = _band_setup(labels, band_px)
    nchan = 0 if image is None else image.shape[-1]
    nmom = 5 if moments else 0
    naux = aux_classes if aux is not None else 0
    nmask = 1 if image_mask is not None else 0
    ncols = 2 + nmom + nchan + naux + nmask

    xs = [lab_b, jnp.arange(nb)]
    if image is not None:
        img_flat = image.reshape(-1, nchan).astype(jnp.float32)
        if pad:
            img_flat = jnp.pad(img_flat, ((0, pad), (0, 0)))
        xs.append(img_flat.reshape(nb, band_px, nchan))
    if aux is not None:
        aux_flat = aux.reshape(-1).astype(jnp.int32)
        if pad:
            aux_flat = jnp.pad(aux_flat, (0, pad))
        xs.append(aux_flat.reshape(nb, band_px))
    if image_mask is not None:
        m_flat = image_mask.reshape(-1).astype(jnp.float32)
        if pad:
            m_flat = jnp.pad(m_flat, (0, pad))
        xs.append(m_flat.reshape(nb, band_px))

    def body(acc, xs):
        it = iter(xs)
        lb = next(it)
        bidx = next(it)
        ib = next(it) if image is not None else None
        ab = next(it) if aux is not None else None
        mb = next(it) if image_mask is not None else None
        oh, base, spilled = _window_onehot(lb, width, num_segments)
        # Global pixel coordinates of this band -> border indicator column
        # (and moment columns), built on the fly: no HBM-resident feature
        # image is ever materialized. Likewise the image mask multiplies
        # channels per band inside the fused feature build — no full-image
        # masked copy ever exists in HBM.
        gidx = bidx * band_px + jnp.arange(band_px, dtype=jnp.int32)
        row = gidx // w
        col = gidx % w
        border = ((row == 0) | (row == h - 1) | (col == 0)
                  | (col == w - 1)) & (gidx < n)
        cols = [jnp.ones((band_px, 1), jnp.float32),
                border.astype(jnp.float32)[:, None]]
        if moments:
            cols.append(_moment_cols(row.astype(jnp.float32),
                                     col.astype(jnp.float32)))
        if ib is not None:
            cols.append(ib if mb is None else ib * mb[:, None])
        if ab is not None:
            cols.append((ab[:, None] == jnp.arange(aux_classes)[None, :])
                        .astype(jnp.float32))
        if mb is not None:
            cols.append(mb[:, None])
        feat = jnp.concatenate(cols, axis=1)          # (band_px, ncols)
        part = _split_dot(oh, feat)                   # (width, ncols)
        cur = jax.lax.dynamic_slice(acc, (base, 0), (width, ncols))
        acc = jax.lax.dynamic_update_slice(acc, cur + part, (base, 0))
        return acc, spilled

    acc0 = jnp.zeros((num_segments + width, ncols), jnp.float32)
    acc, spills = jax.lax.scan(body, acc0, tuple(xs))
    acc = acc[:num_segments]
    mom = acc[:, 2:2 + nmom] if moments else None
    sums = acc[:, 2 + nmom:2 + nmom + nchan]
    ah = acc[:, 2 + nmom + nchan:2 + nmom + nchan + naux] \
        if aux is not None else None
    mc = acc[:, -1] if image_mask is not None else None
    return LabelStats(acc[:, 0], acc[:, 1], sums, jnp.any(spills), mom, ah,
                      mc)


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _label_stats_exact(labels: jax.Array, image: jax.Array | None,
                       aux: jax.Array | None,
                       image_mask: jax.Array | None, num_segments: int,
                       aux_classes: int = 0, moments: bool = False):
    """Scatter-based fallback (exact for arbitrary label images)."""
    shape = labels.shape
    h, w = shape[0], int(labels.size // shape[0])
    flat = jnp.clip(labels.reshape(-1), 0, num_segments - 1)
    counts = jnp.zeros((num_segments,), jnp.float32).at[flat].add(1.0)
    border = jnp.zeros(shape, bool)
    for ax in range(labels.ndim):
        idx = [slice(None)] * labels.ndim
        idx[ax] = 0
        border = border.at[tuple(idx)].set(True)
        idx[ax] = shape[ax] - 1
        border = border.at[tuple(idx)].set(True)
    border_hits = jnp.zeros((num_segments,), jnp.float32).at[flat].add(
        border.reshape(-1).astype(jnp.float32))
    mc = None
    if image_mask is not None:
        mflat = image_mask.reshape(-1).astype(jnp.float32)
        mc = jnp.zeros((num_segments,), jnp.float32).at[flat].add(mflat)
        mc = mc.at[0].set(0.0)
    if image is not None:
        img_flat = image.reshape(-1, image.shape[-1]).astype(jnp.float32)
        if image_mask is not None:
            img_flat = img_flat * image_mask.reshape(-1, 1).astype(
                jnp.float32)
        sums = jax.ops.segment_sum(img_flat, flat,
                                   num_segments=num_segments)
        sums = sums.at[0].set(0.0)
    else:
        sums = jnp.zeros((num_segments, 0), jnp.float32)
    mom = None
    if moments:
        gidx = jnp.arange(labels.size, dtype=jnp.int32)
        rf = (gidx // w).astype(jnp.float32)
        cf = (gidx % w).astype(jnp.float32)
        mom = jax.ops.segment_sum(_moment_cols(rf, cf), flat,
                                  num_segments=num_segments).at[0].set(0.0)
    ah = None
    if aux is not None:
        af = jnp.clip(aux.reshape(-1).astype(jnp.int32), 0, aux_classes - 1)
        ah = jnp.zeros((num_segments, aux_classes), jnp.float32).at[
            flat, af].add(1.0).at[0].set(0.0)
    # Row 0 (background) is always zero, matching the windowed path (which
    # never accumulates unlabeled pixels).
    return LabelStats(counts.at[0].set(0.0), border_hits.at[0].set(0.0),
                      sums, jnp.bool_(False), mom, ah, mc)


def label_stats(labels: jax.Array, image: jax.Array | None,
                num_segments: int, width: int = 512,
                band_px: int | None = None, aux: jax.Array | None = None,
                aux_classes: int = 0, moments: bool = False,
                image_mask: jax.Array | None = None) -> LabelStats:
    """Per-label [count, border-pixel count, channel sums, spatial moments,
    aux-value histogram] in one fused pass.

    ``labels``: int32, 0 = background, positive ids must be *band-local*
    (sequential ids from rank_labels / watershed over ranked markers). If the
    id window spills, the result switches to the exact scatter formulation
    via lax.cond — correctness never depends on band-locality.
    ``image``: optional labels.shape + (C,) intensities for per-label sums.
    ``aux``/``aux_classes``: optional int image in [0, aux_classes) -> per-
    label histogram (the erosion-depth table of the ecoli engine).
    ``moments``: add [r, c, r^2, c^2, rc] sums (regionprops shape columns).
    ``image_mask``: optional labels.shape 0/1 array; channel sums then cover
    masked pixels only and ``mask_counts`` reports the per-label masked
    count — the fused path for measuring eroded cells in the same pass as
    full-cell shape stats (counts/border/moments stay full-label). The
    multiply happens per band inside the feature build, so no masked copy
    of ``image`` is ever materialized in HBM.
    """
    if band_px is None:
        band_px = _pick_band_px(labels.size)
    win = _label_stats_windowed(labels, image, aux, image_mask,
                                num_segments, width, band_px,
                                aux_classes, moments)

    def _exact(l, i, a, m):
        e = _label_stats_exact(l, i, a, m, num_segments, aux_classes,
                               moments)
        return tuple(x for x in (e.counts, e.border_hits, e.sums, e.moments,
                                 e.aux_hist, e.mask_counts) if x is not None)

    def _fast(l, i, a, m):
        return tuple(x for x in (win.counts, win.border_hits, win.sums,
                                 win.moments, win.aux_hist, win.mask_counts)
                     if x is not None)

    outs = jax.lax.cond(win.spill, _exact, _fast, labels, image, aux,
                        image_mask)
    outs = list(outs)
    counts = outs.pop(0)
    border_hits = outs.pop(0)
    sums = outs.pop(0)
    mom = outs.pop(0) if moments else None
    ah = outs.pop(0) if aux is not None else None
    mc = outs.pop(0) if image_mask is not None else None
    return LabelStats(counts, border_hits, sums, win.spill, mom, ah, mc)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _label_lookup_windowed(labels: jax.Array, table: jax.Array,
                           width: int, band_px: int, out_dtype=None):
    num_segments = table.shape[0]
    lab_b, n, nb, pad = _band_setup(labels, band_px)
    tbl = jnp.pad(table.astype(jnp.float32), (0, width))

    def body(_, lb):
        oh, base, spilled = _window_onehot(lb, width, num_segments)
        tslice = jax.lax.dynamic_slice(tbl, (base,), (width,))
        dn = (((1,), (0,)), ((), ()))
        if oh.dtype == jnp.bfloat16:
            # Barriers block the excess-precision convert elision and the
            # dot-merge rewrite; see _split_dot.
            hi = jax.lax.optimization_barrier(tslice.astype(jnp.bfloat16))
            lo = (tslice - hi.astype(jnp.float32)).astype(jnp.bfloat16)
            oh2 = jax.lax.optimization_barrier(oh)
            vals = jax.lax.dot_general(oh, hi[:, None], dn,
                                       preferred_element_type=jnp.float32)
            vals += jax.lax.dot_general(oh2, lo[:, None], dn,
                                        preferred_element_type=jnp.float32)
        else:
            vals = jax.lax.dot_general(oh, tslice[:, None], dn,
                                       precision=jax.lax.Precision.HIGHEST)
        return None, (vals[:, 0], spilled)

    _, (vals, spills) = jax.lax.scan(body, None, lab_b)
    out = vals.reshape(-1)[:n].reshape(labels.shape)
    if out_dtype is not None:
        out = out.astype(out_dtype)   # in-program cast: no extra f32 buffer
    return out, jnp.any(spills)


def label_lookup(labels: jax.Array, table: jax.Array, width: int = 512,
                 band_px: int | None = None, out_dtype=None) -> jax.Array:
    """Gather-free ``table[labels]`` for band-local label images.

    ``table``: (num_segments,) values; returned as float32 (int tables up to
    2^24 are exact), or ``out_dtype`` when given. Falls back to a real
    gather on window spill.
    """
    if band_px is None:
        band_px = _pick_band_px(labels.size)
    out, spill = _label_lookup_windowed(labels, table, width, band_px,
                                        out_dtype)
    dt = out_dtype or jnp.float32
    return jax.lax.cond(
        spill,
        lambda l, t: t.astype(jnp.float32)[
            jnp.clip(l, 0, t.shape[0] - 1)].astype(dt),
        lambda l, t: out,
        labels, table)


def remove_small_holes_fast(mask: jax.Array, area_threshold: int = 64,
                            connectivity: int = 1,
                            num_segments: int = 32768,
                            max_iters: int = 512,
                            flood_max_run: int | None = None,
                            exact_fallback: bool = True) -> jax.Array:
    """skimage remove_small_holes without 4M-table scatter/gather.

    A hole is a complement component with no border contact, so one border
    flood (bool or-scans) isolates the hole pixels first and the CCL+rank
    runs only on THOSE — sparse, hole-diameter-bounded structures whose
    scan doubling caps at ~sqrt(area_threshold) — instead of labeling the
    entire complement including the image-sized background component."""
    from hiprfish_tpu.ops import labeling as lab

    m = mask.astype(bool)
    comp = ~m
    reach = lab.flood_reach(lab.border_mask(mask.shape), comp, connectivity,
                            max_iters, flood_max_run)
    holes = comp & ~reach
    # cap: a component of area < T has diameter < T, but typical holes are
    # compact; 4*sqrt(T) covers elongated ones, and longer runs only cost
    # extra fixpoint iterations, never correctness
    cap = max(8, 4 * int(float(area_threshold) ** 0.5))
    seq, n = rank_labels(lab.label(holes, connectivity, max_iters, cap),
                         connectivity, max_iters, cap)

    def fast(seq):
        seqc = jnp.minimum(seq, num_segments - 1)
        st = label_stats(seqc, None, num_segments)
        hole_tbl = (st.counts < area_threshold).astype(jnp.float32)
        hole = label_lookup(seqc, hole_tbl) > 0.5
        return m | (hole & holes)

    def slow(seq):
        from hiprfish_tpu.ops.morphology import remove_small_holes
        return remove_small_holes(m, area_threshold, connectivity)

    if not exact_fallback:
        # both lax.cond branches compile; the exact fallback embeds a
        # second whole-image CCL (seconds of XLA compile at 2000^2)
        # for the n >= num_segments case that real images never reach —
        # callers with bounded hole counts trade it for a no-op
        return jax.lax.cond(n < num_segments, fast, lambda s: m, seq)
    return jax.lax.cond(n < num_segments, fast, slow, seq)


def remove_small_objects_fast(mask: jax.Array, min_size: int,
                              connectivity: int = 2,
                              num_segments: int = 32768,
                              max_iters: int = 512,
                              exact_fallback: bool = True) -> jax.Array:
    """remove_small_objects without the 4M-table scatter/gather: label ->
    rank -> windowed counts -> windowed keep lookup. Exact fallbacks kick in
    on window spill; id overflow beyond num_segments falls back to the
    classic path.

    ``exact_fallback=False`` replaces the overflow branch with a no-filter
    pass-through: XLA sizes a cond's temp arena for its WORST branch, and
    the classic path's mask.size-entry table is gigabytes on full 3D
    volumes — callers that bound their component count (e.g. the 3D seeder,
    whose markers are capped at max_cells) opt out of paying for it."""
    from hiprfish_tpu.ops import labeling as lab

    lbl = lab.label(mask, connectivity, max_iters)
    seq, n = rank_labels(lbl, connectivity, max_iters)

    def fast(seq):
        seqc = jnp.minimum(seq, num_segments - 1)
        stats = label_stats(seqc, None, num_segments)
        keep_tbl = (stats.counts >= min_size).astype(jnp.float32)
        keep = label_lookup(seqc, keep_tbl) > 0.5
        return mask & keep

    def slow(seq):
        if not exact_fallback:
            return mask
        size = mask.size
        flat = jnp.clip(lbl.reshape(-1), 0, size)
        counts = jnp.zeros((size + 1,), jnp.int32).at[flat].add(1)
        return mask & (counts[flat].reshape(mask.shape) >= min_size)

    return jax.lax.cond(n < num_segments, fast, slow, seq)
