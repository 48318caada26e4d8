"""3D LP-CV enhancement: the pruned selection network that gives the
interpolated quartiles without a sort, inside the XLA chunk sweep
(pipeline/segment3d._lp_cv_3d_device), and the streamed measurement."""

import numpy as np
import jax.numpy as jnp
import pytest

from hiprfish_tpu.ops import line_profile as lp


def test_selection_network_exact_order_statistics(rng):
    for n, outs in [(72, (17, 18, 53, 54)), (6, (1, 2, 3, 4)),
                    (9, (2, 6)), (24, (5, 6, 17, 18))]:
        net = lp.selection_network(n, outs)
        for trial in range(200):
            v = (rng.rand(n) if trial % 2
                 else rng.randint(0, 5, n)).astype(np.float32)
            w = v.copy()
            for a, b in net:
                w[a], w[b] = min(w[a], w[b]), max(w[a], w[b])
            s = np.sort(v)
            for r in outs:
                assert w[r] == s[r]


def test_quartile_ranks_match_reference_percentile(rng):
    # interpolation weights must reproduce np.percentile(..., (25, 75))
    for t in (6, 9, 72):
        (lo25, hi25, f25), (lo75, hi75, f75) = lp._quartile_ranks(t)
        v = np.sort(rng.rand(t))
        lq = v[lo25] * (1 - f25) + v[hi25] * f25
        uq = v[lo75] * (1 - f75) + v[hi75] * f75
        np.testing.assert_allclose(lq, np.percentile(v, 25), rtol=1e-6)
        np.testing.assert_allclose(uq, np.percentile(v, 75), rtol=1e-6)


@pytest.mark.parametrize("t", [6, 9, 72])
def test_network_combine_matches_sort_combine(rng, t):
    """The selection-network combine over a leading orientation axis
    equals the jnp.sort combine over a trailing one (ties included)."""
    v = rng.rand(t, 5, 7, 3).astype(np.float32)
    v[:, 0] = np.round(v[:, 0] * 3) / 3          # many ties
    got = np.asarray(lp._lp_cv_combine_network(jnp.asarray(v)))
    want = np.asarray(lp._lp_cv_combine(jnp.moveaxis(jnp.asarray(v), 0, -1)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("chunk", [16, 64])
def test_sweep_matches_unchunked_sort_reference(rng, chunk):
    """The chunked sweep (selection-network quartiles) equals the
    unchunked enhancement (jnp.sort quartiles) for any chunk edge."""
    from hiprfish_tpu.pipeline import segment3d

    vol = jnp.asarray(rng.rand(40, 36, 14).astype(np.float32))
    got = segment3d._lp_cv_3d_device(vol, 11, 9, 9, chunk, False)
    want = lp.lp_cv_enhance_3d(vol, 11, 9, 9)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


def test_chunked_dispatch_cpu_takes_xla_path(rng):
    # the chunked enhancement returns f32 in the caller's layout, and the
    # xzy layout is the xyz result transposed
    from hiprfish_tpu.config import SegmentationConfig
    from hiprfish_tpu.pipeline import segment3d

    cfg = SegmentationConfig(patch_size=5, theta_range=3, phi_range=3)
    vol = jnp.asarray(rng.rand(24, 28, 12).astype(np.float32))
    out = segment3d.lp_cv_enhance_3d_chunked(vol, cfg, chunk_xy=16)
    assert out.shape == vol.shape and out.dtype == jnp.float32
    out_xzy = segment3d.lp_cv_enhance_3d_chunked(
        vol.transpose(0, 2, 1), cfg, chunk_xy=16, layout="xzy")
    np.testing.assert_allclose(np.asarray(out_xzy),
                               np.asarray(out).transpose(0, 2, 1))


def test_measure_volume_streamed_cm_matches_numpy(rng):
    from hiprfish_tpu.pipeline import segment3d

    X, Y, Z, C, mc = 64, 48, 10, 5, 32
    lab = np.zeros((X, Y, Z), np.int32)
    nid = 0
    for x0 in range(0, X, 16):
        for y0 in range(0, Y, 16):
            nid += 1
            lab[x0 + 2:x0 + 10, y0 + 2:y0 + 12, 3:9] = nid
    data = rng.rand(C, Z, X, Y).astype(np.float32)

    avg = np.asarray(segment3d.measure_volume_streamed(
        jnp.asarray(lab), lambda z0, zc: jnp.asarray(data[:, z0:z0 + zc]),
        Z, 2, C, mc, channels_major=True))
    for i in range(1, nid + 1):
        m = lab == i
        expect = data[:, np.transpose(m, (2, 0, 1))].mean(axis=1)
        np.testing.assert_allclose(avg[i], expect, atol=1e-4)
