"""Connected-component labeling and label utilities, jittable.

The reference relies on skimage.measure.label / relabel_sequential /
clear_border / remove_small_objects throughout its segmentation engines
(e.g. spectral_image_measurement.py:97-115,
multispecies_spectral_image_measurement.py:136-157). Flood-fill labeling is
inherently sequential, so here it is reformulated as iterative min-label
propagation with pointer jumping: every pixel starts with its own linear index
as a label, each step takes the min over neighbors, and a gather through the
label array ("label of my label") compresses chains — O(log diameter)-ish
convergence, all as fused element-wise ops + one gather per step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Python int, not a jnp array — see ops/segstats.py:_INF for why.
_INF = 2**30


def _neighbor_shifts(ndim: int, connectivity: int):
    """Offsets of the neighborhood (excluding center)."""
    import itertools

    shifts = []
    for off in itertools.product((-1, 0, 1), repeat=ndim):
        if all(o == 0 for o in off):
            continue
        if sum(abs(o) for o in off) <= connectivity:
            shifts.append(off)
    return shifts


def shifted(arr, off, fill):
    """Public wrapper: shift ``arr`` so that out[p] = arr[p - off]."""
    out = arr
    for ax, o in enumerate(off):
        if o == 0:
            continue
        n = arr.shape[ax]
        if o > 0:
            pad = [(0, 0)] * arr.ndim
            pad[ax] = (o, 0)
            out = jax.lax.slice_in_dim(
                jnp.pad(out, pad, constant_values=fill), 0, n, axis=ax
            )
        else:
            pad = [(0, 0)] * arr.ndim
            pad[ax] = (0, -o)
            out = jax.lax.slice_in_dim(
                jnp.pad(out, pad, constant_values=fill), -o, n - o, axis=ax
            )
    return out


def _run_min_scan(values: jax.Array, mask: jax.Array, axis: int,
                  reverse: bool, max_run: int | None = None) -> jax.Array:
    """Propagate the running min of ``values`` along contiguous True-runs of
    ``mask`` along ``axis`` — a segmented min-scan via lax.associative_scan.

    Each element is the function f(x) = gate ? min(x, v) : v; composition of
    such functions is (gA & gB, gB ? min(cA, cB) : cB), which is associative,
    so the whole propagation is one log-depth scan (no gathers — a dense
    formulation of flood labeling).

    ``max_run`` caps the doubling distance: when the caller knows every
    mask run is shorter (components bounded by a tile margin / cell size),
    the tail doubling steps — the majority at image scale, each a full
    HBM pass — are provably idle. A longer-than-cap run only costs extra
    fixpoint iterations in the calling while_loop, never correctness.
    """
    # Gate between an element and its predecessor in scan direction.
    off = [0] * mask.ndim
    off[axis] = -1 if reverse else 1
    prev_mask = shifted(mask, tuple(off), False)
    gate = mask & prev_mask

    # Hillis-Steele doubling: log2(n) static steps of shift+select+min.
    # (lax.associative_scan generates size-dependent slice trees whose XLA
    # compile time blows up at megapixel scales; this unrolled form compiles
    # fast and runs as ~2*log2(n) fused passes.)
    n = values.shape[axis]
    if max_run is not None:
        n = min(n, max_run)
    g, v = gate, values
    d = 1
    while d < n:
        off_d = [0] * mask.ndim
        off_d[axis] = -d if reverse else d
        ga = shifted(g, tuple(off_d), False)
        va = shifted(v, tuple(off_d), _INF)
        v = jnp.where(g, jnp.minimum(va, v), v)
        g = g & ga
        d *= 2
    return jnp.where(mask, v, values)


def _run_or_scan(reach: jax.Array, mask: jax.Array, axis: int,
                 reverse: bool, max_run: int | None = None) -> jax.Array:
    """Propagate True along contiguous mask runs (segmented OR-scan via
    Hillis-Steele doubling on bool vectors — 4x narrower than the int32
    min-scan). ``max_run`` as in _run_min_scan."""
    off = [0] * mask.ndim
    off[axis] = -1 if reverse else 1
    gate = mask & shifted(mask, tuple(off), False)
    n = reach.shape[axis]
    if max_run is not None:
        n = min(n, max_run)
    g, r = gate, reach
    d = 1
    while d < n:
        off_d = [0] * mask.ndim
        off_d[axis] = -d if reverse else d
        ga = shifted(g, tuple(off_d), False)
        ra = shifted(r, tuple(off_d), False)
        r = r | (g & ra)
        g = g & ga
        d *= 2
    return r


def _block_pool(x: jax.Array, c: int, op: str) -> jax.Array:
    """Factor-c block reduce per axis (pad with False — conservative).

    Reduced axis-by-axis with c strided slices per axis, NOT a single
    reshape to (s0/c, c, s1/c, c, ...): that 2*ndim-rank bool
    intermediate puts a length-c pair in the two minor positions, which a
    tiled device layout pads many times over. Strided slices keep the
    array rank-ndim
    with large minor dims throughout."""
    pads = [(0, (-s) % c) for s in x.shape]
    if any(p[1] for p in pads):
        x = jnp.pad(x, pads, constant_values=False)
    comb = jnp.logical_and if op == "all" else jnp.logical_or
    for ax in range(x.ndim):
        sl = [slice(None)] * x.ndim
        r = None
        for k in range(c):
            sl[ax] = slice(k, None, c)
            piece = x[tuple(sl)]
            r = piece if r is None else comb(r, piece)
        x = r
    return x


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def flood_reach(seeds: jax.Array, mask: jax.Array, connectivity: int = 1,
                max_iters: int = 512, max_run: int | None = None):
    """Pixels of ``mask`` reachable from ``seeds`` through ``mask`` —
    binary flood fill with the same scan machinery as label() but carried on
    booleans (used by hole filling / border-connectivity tests).

    Large inputs take a two-level route: flood a coarse grid of
    fully-inside-mask blocks first (two face-adjacent solid blocks are
    always fine-connected, so every voxel of a reached solid block is a
    valid seed), then run the exact fine flood from the upsampled seeds —
    it converges in a couple of rounds instead of tracing the whole domain.
    Exactness is never at
    stake: the coarse phase only ADDS provably-reachable seeds and the fine
    loop still iterates to its fixed point."""
    c = 4
    if seeds.size >= (1 << 22) and all(s >= 4 * c for s in mask.shape):
        solid = _block_pool(mask, c, "all")
        cseeds = _block_pool(seeds & mask, c, "any") & solid
        creach = _flood_reach_flat(cseeds, solid, 1, max_iters, max_run)
        # Upsample by axis-gather (take with i//c), not jnp.repeat: repeat
        # lowers through a broadcast whose split (s/c, c) pair lands in the
        # minor tile positions on the last axis — same ~32x bool padding
        # blow-up as the reshape pool above.
        up = creach
        for ax, s in enumerate(mask.shape):
            idx = jnp.arange(s, dtype=jnp.int32) // c
            up = jnp.take(up, idx, axis=ax)
        seeds = seeds | (up & mask)
    return _flood_reach_flat(seeds, mask, connectivity, max_iters,
                             max_run)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _flood_reach_flat(seeds: jax.Array, mask: jax.Array,
                      connectivity: int = 1, max_iters: int = 512,
                      max_run: int | None = None):
    ndim = mask.ndim
    # face shifts are the or-scans' d=1 step; only diagonals do work here
    shifts = [s for s in _neighbor_shifts(ndim, connectivity)
              if sum(abs(o) for o in s) >= 2]
    reach0 = seeds & mask

    def body(state):
        reach, _, it = state
        cur = reach
        nb = cur
        for off in shifts:
            nb = nb | shifted(cur, off, False)
        cur = mask & (cur | nb)
        for axis in range(ndim):
            cur = _run_or_scan(cur, mask, axis, False, max_run)
            cur = _run_or_scan(cur, mask, axis, True, max_run)
        return cur, jnp.any(cur != reach), it + 1

    def cond(state):
        return state[1] & (state[2] < max_iters)

    reach, _, _ = jax.lax.while_loop(
        cond, body, (reach0, jnp.bool_(True), jnp.int32(0)))
    return reach



def _window_pool(x: jax.Array, reduce_fn, fill):
    """Exact reduce over the full 3^ndim neighborhood (separable axis
    pools). For full connectivity this replaces the per-diagonal shift
    chain: 3 small fused passes instead of 3^ndim - 2^ndim - ... shifted
    operands in one giant fusion — ~3x fewer HLO ops in every
    while_loop body (compile time) and lower register pressure (run
    time). Separability is exact for min/max/or."""
    for ax in range(x.ndim):
        off_p = [0] * x.ndim
        off_p[ax] = 1
        off_m = [0] * x.ndim
        off_m[ax] = -1
        x = reduce_fn(reduce_fn(x, shifted(x, tuple(off_p), fill)),
                      shifted(x, tuple(off_m), fill))
    return x


def border_mask(shape) -> jax.Array:
    border = jnp.zeros(shape, bool)
    for ax in range(len(shape)):
        idx = [slice(None)] * len(shape)
        idx[ax] = 0
        border = border.at[tuple(idx)].set(True)
        idx[ax] = shape[ax] - 1
        border = border.at[tuple(idx)].set(True)
    return border


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def label(mask: jax.Array, connectivity: int | None = None,
          max_iters: int = 512, max_run: int | None = None):
    """Label connected components of a boolean mask.

    connectivity follows skimage.measure.label semantics: 1 = faces only,
    ndim = full neighborhood (default). Returns int32 labels with arbitrary
    positive ids (use relabel_sequential for 1..n ids).

    Algorithm: iterative min-label propagation where each round does one
    neighbor-min step over the DIAGONAL shifts (face-adjacent propagation
    is exactly the d=1 step of the axis scans, so face shifts are dead
    passes) followed by segmented min-scans along every axis in both
    directions (each scan propagates labels across a straight run at once).
    Rounds repeat under a while_loop until fixpoint — a handful of rounds
    for typical masks, all dense vector work with zero gathers.

    ``max_run`` (static): optional upper bound on mask run lengths, capping
    the scans' doubling distance (see _run_min_scan) — pass the tile margin
    / max structure size when known; convergence is checked regardless.
    """
    ndim = mask.ndim
    if connectivity is None:
        connectivity = ndim
    shifts = [s for s in _neighbor_shifts(ndim, connectivity)
              if sum(abs(o) for o in s) >= 2]
    size = mask.size
    lin = (jnp.arange(size, dtype=jnp.int32) + 1).reshape(mask.shape)
    lbl0 = jnp.where(mask, lin, _INF)
    # (No coarse-block pre-seeding here, deliberately: the segmented run
    # scans below already propagate across whole straight spans per round,
    # so fixpoint rounds are bound by component TORTUOSITY, not size —
    # measured 3 rounds with or without solid-block seeding on both
    # cell-sized and 1100-px components. flood_reach keeps its coarse
    # route because the fill-holes background is the one high-tortuosity
    # large component in the pipelines.)
    full_conn = connectivity == ndim

    def body(state):
        lbl, _, it = state
        cur = lbl
        if full_conn:
            # full neighborhood = separable 3^ndim min-pool (includes the
            # face steps — a superset of the diagonal step, still exact
            # min-label propagation, just faster per round)
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
        return cur, jnp.any(cur != lbl), it + 1

    def cond(state):
        return state[1] & (state[2] < max_iters)

    lbl, _, _ = jax.lax.while_loop(
        cond, body, (lbl0, jnp.bool_(True), jnp.int32(0)))
    return jnp.where(mask, lbl, 0)


@jax.jit
def relabel_sequential(labels: jax.Array):
    """Remap positive labels to 1..n preserving order (skimage
    relabel_sequential). Returns (new_labels, n_labels)."""
    size = labels.size
    flat = labels.reshape(-1).astype(jnp.int32)
    # Label values are bounded by size (linear-index construction) — clamp to
    # be safe with externally supplied labels.
    flat_c = jnp.clip(flat, 0, size)
    presence = jnp.zeros((size + 1,), jnp.int32).at[flat_c].set(1)
    presence = presence.at[0].set(0)
    newid = jnp.cumsum(presence).astype(jnp.int32)
    out = jnp.where(flat > 0, newid[flat_c], 0).reshape(labels.shape)
    return out, newid[-1]


@jax.jit
def clear_border(labels: jax.Array):
    """Zero every component touching the image border (skimage clear_border)."""
    size = labels.size
    flat = jnp.clip(labels.reshape(-1).astype(jnp.int32), 0, size)
    border = jnp.zeros(labels.shape, bool)
    for ax in range(labels.ndim):
        idx = [slice(None)] * labels.ndim
        idx[ax] = 0
        border = border.at[tuple(idx)].set(True)
        idx[ax] = labels.shape[ax] - 1
        border = border.at[tuple(idx)].set(True)
    marked = jnp.zeros((size + 1,), jnp.int32).at[
        jnp.where(border.reshape(-1), flat, 0)
    ].set(1)
    marked = marked.at[0].set(0)
    drop = marked[flat].reshape(labels.shape) > 0
    return jnp.where(drop, 0, labels)


@functools.partial(jax.jit, static_argnums=(1, 2))
def remove_small_objects(mask: jax.Array, min_size: int, connectivity: int | None = None):
    """Drop connected components smaller than min_size from a boolean mask
    (skimage.morphology.remove_small_objects)."""
    lbl = label(mask, connectivity)
    size = mask.size
    flat = jnp.clip(lbl.reshape(-1), 0, size)
    counts = jnp.zeros((size + 1,), jnp.int32).at[flat].add(1)
    keep = counts[flat].reshape(mask.shape) >= min_size
    return mask & keep


@functools.partial(jax.jit, static_argnums=(1, 2))
def filter_and_relabel(labels: jax.Array, min_size: int,
                       drop_border: bool = True):
    """Fused remove_small_labels + clear_border + relabel_sequential.

    One counts scatter, one border scatter, one cumsum, and a single gather
    build the final sequential labels — vs 3 gathers + 3 scatters when the
    three ops run separately.
    Returns (new_labels, n_labels).
    """
    size = labels.size
    flat = jnp.clip(labels.reshape(-1).astype(jnp.int32), 0, size)
    counts = jnp.zeros((size + 1,), jnp.int32).at[flat].add(1)
    if drop_border:
        border = jnp.zeros(labels.shape, bool)
        for ax in range(labels.ndim):
            idx = [slice(None)] * labels.ndim
            idx[ax] = 0
            border = border.at[tuple(idx)].set(True)
            idx[ax] = labels.shape[ax] - 1
            border = border.at[tuple(idx)].set(True)
        touched = jnp.zeros((size + 1,), jnp.int32).at[
            jnp.where(border.reshape(-1), flat, 0)
        ].set(1)
        keep = (counts >= min_size) & (touched == 0)
    else:
        keep = counts >= min_size
    keep = keep.at[0].set(False)
    newid = jnp.cumsum(keep.astype(jnp.int32))
    value_tbl = jnp.where(keep, newid, 0).astype(jnp.int32)
    out = value_tbl[flat].reshape(labels.shape)
    return out, newid[-1]


@functools.partial(jax.jit, static_argnums=(1,))
def remove_small_labels(labels: jax.Array, min_size: int):
    """Zero label regions smaller than min_size, keeping remaining ids
    (skimage remove_small_objects on a label image)."""
    size = labels.size
    flat = jnp.clip(labels.reshape(-1).astype(jnp.int32), 0, size)
    counts = jnp.zeros((size + 1,), jnp.int32).at[flat].add(1)
    keep = counts[flat].reshape(labels.shape) >= min_size
    return jnp.where(keep, labels, 0)
