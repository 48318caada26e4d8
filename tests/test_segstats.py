"""Oracle tests for ops/segstats.py — the gather/scatter-free label
statistics that back the fused pipeline's filter+measure stage."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy import ndimage as ndi

from hiprfish_tpu.ops import labeling as lab
from hiprfish_tpu.ops import segstats


def _blob_mask(rng, h=120, w=90, density=0.35):
    m = rng.rand(h, w) < density
    return ndi.binary_opening(m)


def _grid_mask(rng, h=256, w=128):
    m = np.zeros((h, w), bool)
    for r in range(8, h - 8, 16):
        for c in range(8, w - 8, 16):
            if rng.rand() < 0.8:
                m[r - 3:r + 3, c - 3:c + 3] = True
    m[0:5, 40:60] = True  # border-touching component
    return m


def test_rank_labels_matches_scipy_order(rng):
    for _ in range(3):
        m = _blob_mask(rng)
        mask = jnp.asarray(m)
        lbl = lab.label(mask, 2, 512)
        seq, n = segstats.rank_labels(lbl, 2, 512)
        ol, on = ndi.label(m, structure=np.ones((3, 3)))
        assert int(n) == on
        # ranks ascend with the component's min linear index, matching
        # skimage relabel_sequential on raster-ordered label images
        mins = {v: np.flatnonzero((ol == v).ravel()).min()
                for v in range(1, on + 1)}
        expect = np.zeros_like(ol)
        for rank, v in enumerate(sorted(mins, key=mins.get), 1):
            expect[ol == v] = rank
        assert np.array_equal(np.asarray(seq), expect)


def test_windowed_stats_match_exact(rng):
    m = _grid_mask(rng)
    seq, n = segstats.rank_labels(jnp.asarray(lab.label(jnp.asarray(m), 2)),
                                  2)
    img = jnp.asarray(rng.rand(*m.shape, 3).astype(np.float32))
    win = segstats._label_stats_windowed(seq, img, None, None, 256, 32,
                                         2048, 0, False)
    exact = segstats._label_stats_exact(seq, img, None, None, 256)
    assert not bool(win.spill)
    assert np.array_equal(np.asarray(win.counts), np.asarray(exact.counts))
    assert np.array_equal(np.asarray(win.border_hits),
                          np.asarray(exact.border_hits))
    np.testing.assert_allclose(np.asarray(win.sums), np.asarray(exact.sums),
                               rtol=1e-4, atol=1e-3)


def test_stats_against_numpy_oracle(rng):
    m = _blob_mask(rng)
    mask = jnp.asarray(m)
    seq, n = segstats.rank_labels(lab.label(mask, 2), 2)
    seq_np = np.asarray(seq)
    img = rng.rand(*m.shape, 4).astype(np.float32)
    st = segstats.label_stats(seq, jnp.asarray(img), 64, width=64)
    border = np.zeros_like(m)
    border[0] = border[-1] = True
    border[:, 0] = border[:, -1] = True
    for v in range(1, min(int(n) + 1, 64)):
        sel = seq_np == v
        assert st.counts[v] == sel.sum()
        assert st.border_hits[v] == (sel & border).sum()
        np.testing.assert_allclose(np.asarray(st.sums)[v], img[sel].sum(0),
                                   rtol=1e-4, atol=1e-3)
    # background row is zero by contract
    assert st.counts[0] == 0 and st.border_hits[0] == 0


def test_spill_falls_back_to_exact(rng):
    m = _blob_mask(rng)
    seq, n = segstats.rank_labels(lab.label(jnp.asarray(m), 2), 2)
    img = jnp.asarray(rng.rand(*m.shape, 2).astype(np.float32))
    # width 2 guarantees window overflow -> the cond fallback must still
    # produce exact results
    tiny = segstats.label_stats(seq, img, 64, width=2)
    exact = segstats._label_stats_exact(seq, img, None, None, 64)
    assert bool(tiny.spill)
    assert np.array_equal(np.asarray(tiny.counts), np.asarray(exact.counts))
    np.testing.assert_allclose(np.asarray(tiny.sums), np.asarray(exact.sums),
                               rtol=1e-5, atol=1e-4)


def test_label_lookup_matches_gather(rng):
    m = _grid_mask(rng)
    seq, _ = segstats.rank_labels(lab.label(jnp.asarray(m), 2), 2)
    tbl = jnp.asarray(rng.randint(0, 5000, 256).astype(np.float32))
    out = segstats.label_lookup(seq, tbl, width=32)
    expect = np.asarray(tbl)[np.clip(np.asarray(seq), 0, 255)]
    assert np.array_equal(np.asarray(out), expect)
    # spilling width must fall back to a real gather
    out2 = segstats.label_lookup(seq, tbl, width=2)
    assert np.array_equal(np.asarray(out2), expect)


def test_moments_and_aux_hist(rng):
    m = _grid_mask(rng)
    seq, n = segstats.rank_labels(lab.label(jnp.asarray(m), 2), 2)
    seq_np = np.asarray(seq)
    depth = rng.randint(0, 7, m.shape).astype(np.int32) * m
    st = segstats.label_stats(seq, None, 256, width=64,
                              aux=jnp.asarray(depth), aux_classes=8,
                              moments=True)
    rows, cols = np.mgrid[0:m.shape[0], 0:m.shape[1]].astype(np.float64)
    for v in range(1, int(n) + 1):
        sel = seq_np == v
        np.testing.assert_allclose(
            np.asarray(st.moments)[v],
            [rows[sel].sum(), cols[sel].sum(), (rows[sel] ** 2).sum(),
             (cols[sel] ** 2).sum(), (rows[sel] * cols[sel]).sum()],
            rtol=1e-4)
        np.testing.assert_array_equal(
            np.asarray(st.aux_hist)[v],
            np.bincount(depth[sel], minlength=8))


def test_remove_small_holes_fast_matches_reference(rng):
    from hiprfish_tpu.ops import morphology as morph
    for thr in (4, 16, 64):
        m = _blob_mask(rng, density=0.6)
        fast = segstats.remove_small_holes_fast(jnp.asarray(m), thr, 1)
        slow = morph.remove_small_holes(jnp.asarray(m), thr, 1)
        assert np.array_equal(np.asarray(fast), np.asarray(slow)), thr


def test_remove_small_objects_fast_matches_reference(rng):
    for min_size in (4, 9, 25):
        m = _blob_mask(rng)
        fast = segstats.remove_small_objects_fast(jnp.asarray(m), min_size, 2)
        slow = lab.remove_small_objects(jnp.asarray(m), min_size, 2)
        assert np.array_equal(np.asarray(fast), np.asarray(slow))


def test_image_mask_stats_match_two_pass(rng):
    """label_stats(image_mask=...) equals the two-pass formulation: full
    shape stats over labels + channel sums over the masked pixels only
    (the fused-eroded-measurement path of fused_ecoli)."""
    m = _blob_mask(rng)
    seq, n = segstats.rank_labels(lab.label(jnp.asarray(m), 2), 2)
    seq_np = np.asarray(seq)
    img = rng.rand(*m.shape, 3).astype(np.float32)
    emask = (rng.rand(*m.shape) > 0.4) & m        # irregular erosion stand-in
    st = segstats.label_stats(seq, jnp.asarray(img), 64, width=64,
                              moments=True,
                              image_mask=jnp.asarray(emask, np.float32))
    for v in range(1, min(int(n) + 1, 64)):
        sel = seq_np == v
        sel_m = sel & emask
        assert st.counts[v] == sel.sum()
        assert st.mask_counts[v] == sel_m.sum()
        np.testing.assert_allclose(np.asarray(st.sums)[v], img[sel_m].sum(0),
                                   rtol=1e-4, atol=1e-3)
    # spill fallback keeps the same semantics
    tiny = segstats.label_stats(seq, jnp.asarray(img), 64, width=2,
                                moments=True,
                                image_mask=jnp.asarray(emask, np.float32))
    assert bool(tiny.spill)
    np.testing.assert_allclose(np.asarray(tiny.mask_counts),
                               np.asarray(st.mask_counts), atol=1e-3)
    np.testing.assert_allclose(np.asarray(tiny.sums), np.asarray(st.sums),
                               rtol=1e-4, atol=1e-3)
