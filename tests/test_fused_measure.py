"""The fused single-program 3D measurement (segment3d.make_fused_measure)
and its scatter-add accumulation (segment3d._stats_cm) must agree with the
per-chunk streamed path and the numpy oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hiprfish_tpu.pipeline import segment3d


def _grid_volume(X=64, Y=48, Z=10, C=5, seed=0):
    rng = np.random.RandomState(seed)
    lab = np.zeros((X, Y, Z), np.int32)
    nid = 0
    for x0 in range(0, X, 16):
        for y0 in range(0, Y, 16):
            nid += 1
            lab[x0 + 2:x0 + 10, y0 + 2:y0 + 12, 3:9] = nid
    return lab, nid, rng.rand(C, Z, X, Y).astype(np.float32)


@pytest.mark.parametrize("z_chunk", [4, 3, 1])
def test_fused_measure_matches_streamed_and_numpy(z_chunk):
    lab, nid, data = _grid_volume()
    C, Z, X, Y = data.shape
    mc = 32
    data_dev = jnp.asarray(data)

    def loader(z0, zc):
        return jax.lax.dynamic_slice(data_dev, (0, z0, 0, 0),
                                     (C, zc, X, Y))

    # z_chunk 4 and 3 leave a tail chunk (10 = 2*4+2 = 3*3+1)
    run = segment3d.make_fused_measure(loader, (X, Y, Z), z_chunk, C, mc)
    avg = np.asarray(run(jnp.transpose(jnp.asarray(lab), (2, 0, 1))))

    streamed = np.asarray(segment3d.measure_volume_streamed(
        jnp.asarray(lab), lambda z0, zc: data[:, z0:z0 + zc], Z, z_chunk,
        C, mc, channels_major=True))
    for i in range(1, nid + 1):
        m = lab == i
        expect = data[:, np.transpose(m, (2, 0, 1))].mean(axis=1)
        np.testing.assert_allclose(avg[i], expect, atol=2e-4)
        np.testing.assert_allclose(streamed[i], expect, atol=2e-4)
    bg = data[:, np.transpose(lab == 0, (2, 0, 1))].mean(axis=1)
    np.testing.assert_allclose(avg[0], bg, rtol=1e-5)
    assert not avg[nid + 1:].any()


def test_fused_measure_signals_band_spill():
    """Ids far apart inside one raster band (which overflowed the old
    banded one-hot window and forced a fallback) are measured exactly by
    the scatter-add accumulation, in the fused and the streamed path."""
    X = Y = 8
    Z = 4
    C = 2
    mc = 600
    lab = np.zeros((X, Y, Z), np.int32)
    lab[0, 0, :] = 1
    lab[5, 5, :] = 520
    data = np.random.default_rng(0).random((C, Z, X, Y)).astype(np.float32)

    def loader(z0, zc):
        return jax.lax.dynamic_slice(
            jnp.asarray(data), (0, z0, 0, 0), (C, zc, X, Y))

    run = segment3d.make_fused_measure(loader, (X, Y, Z), 2, C, mc)
    avg = np.asarray(run(jnp.transpose(jnp.asarray(lab), (2, 0, 1))))
    streamed = np.asarray(segment3d.measure_volume_streamed(
        jnp.asarray(lab), lambda z0, zc: data[:, z0:z0 + zc], Z, 2, C, mc,
        channels_major=True))
    for out in (avg, streamed):
        np.testing.assert_allclose(out[1], data[:, :, 0, 0].mean(axis=1),
                                   rtol=1e-5)
        np.testing.assert_allclose(out[520], data[:, :, 5, 5].mean(axis=1),
                                   rtol=1e-5)


@pytest.mark.parametrize("planes", [1, 3])
def test_stats_cm_matches_numpy(planes):
    """[count, channel sums] per label over (planes, H, W) label slabs and
    (C, planes, H, W) data in bf16 or f32; row 0 is the background,
    out-of-range labels are dropped."""
    rng = np.random.RandomState(planes)
    nseg, C = 40, 3
    lab = rng.randint(0, nseg + 5, (planes, 16, 24)).astype(np.int32)
    img = rng.rand(C, planes, 16, 24).astype(np.float32)
    for dt in (jnp.float32, jnp.bfloat16):
        x = jnp.asarray(img, dt)
        acc = np.asarray(segment3d._stats_cm(jnp.asarray(lab), x, nseg))
        xf = np.asarray(x.astype(jnp.float32))
        flat = lab.reshape(-1)
        ok = flat < nseg
        counts = np.bincount(flat[ok], minlength=nseg)
        np.testing.assert_array_equal(acc[:, 0], counts)
        for c in range(C):
            sums = np.bincount(flat[ok], weights=xf[c].reshape(-1)[ok],
                               minlength=nseg)
            np.testing.assert_allclose(acc[:, 1 + c], sums, rtol=1e-5,
                                       atol=1e-5)
