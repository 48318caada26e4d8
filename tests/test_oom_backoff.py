"""OOM recovery subsystem (utils/oom.py): size-ladder retry semantics and
its wiring into the chunked 3D pipeline and the DP batch runner."""

import numpy as np
import pytest

from hiprfish_tpu.utils import oom


class FakeOom(RuntimeError):
    def __str__(self):
        return "RESOURCE_EXHAUSTED: Out of memory while trying to allocate 1024 bytes."


def test_backoff_walks_ladder_until_fit():
    calls = []

    def fn(size):
        calls.append(size)
        if size > 32:
            raise FakeOom()
        return size * 2

    result, used = oom.run_with_backoff(fn, oom.halving_ladder(128, 16))
    assert calls == [128, 64, 32]
    assert (result, used) == (64, 32)


def test_backoff_propagates_non_oom_immediately():
    def fn(size):
        raise ValueError("real bug")

    with pytest.raises(ValueError, match="real bug"):
        oom.run_with_backoff(fn, [128, 64])


def test_backoff_exhausted_reraises_oom():
    def fn(size):
        raise FakeOom()

    with pytest.raises(FakeOom):
        oom.run_with_backoff(fn, [8, 4])


def test_halving_ladder():
    assert list(oom.halving_ladder(128, 32)) == [128, 64, 32]
    assert list(oom.halving_ladder(100, 32)) == [100, 50, 32]
    assert list(oom.halving_ladder(16, 32)) == [32]


def test_is_oom_error_patterns():
    assert oom.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: foo"))
    assert oom.is_oom_error(RuntimeError("Out of memory allocating 1g"))
    assert not oom.is_oom_error(RuntimeError("invalid argument"))


def test_segment3d_backs_off_chunk_size(rng, monkeypatch):
    """segment_3d_from_sum retries the enhancement sweep at smaller
    chunk_xy when the first size OOMs."""
    from hiprfish_tpu.pipeline import segment3d

    real = segment3d.lp_cv_enhance_3d_chunked
    seen = []

    def flaky(vol, cfg, cx, bf16=None):
        seen.append(cx)
        if cx > 32:
            raise FakeOom()
        return real(vol, cfg, cx, bf16)

    monkeypatch.setattr(segment3d, "lp_cv_enhance_3d_chunked", flaky)
    import jax.numpy as jnp
    from hiprfish_tpu.config import SegmentationConfig

    vol = jnp.asarray(rng.rand(48, 48, 12).astype(np.float32))
    seg, n, enhanced = segment3d.segment_3d_from_sum(
        vol, SegmentationConfig(), max_cells=64, chunk_xy=128)
    assert seen == [128, 64, 32]
    assert enhanced.shape == vol.shape


def test_batch_runner_splits_batch_on_oom(tmp_path, rng, monkeypatch):
    """run_batch_pipeline falls back to sequential half-batches on OOM and
    still writes every sample's artifacts."""
    import jax.numpy as jnp

    from hiprfish_tpu.config import SEVEN_BIT, ClassifierConfig, \
        SegmentationConfig
    from hiprfish_tpu.models import train as mtrain
    from hiprfish_tpu.models.classifier import train_classifier
    from hiprfish_tpu.parallel import fov_batch
    from hiprfish_tpu.utils import synthetic

    layout = SEVEN_BIT
    codes = [3, 9, 17, 33]
    lut = synthetic.fluorophore_spectra(layout)
    rows, cs = [], []
    for c in codes:
        spec = synthetic.barcode_spectrum(layout, c, lut)
        r = np.clip(rng.uniform(0.8, 1.2, (20, 1)) * spec[None, :]
                    + rng.randn(20, layout.n_channels) * 0.01, 0, None)
        rows.append(r)
        cs += [layout.code_str(c)] * 20
    spectra = np.concatenate(rows).astype(np.float32)
    spectra /= np.maximum(spectra.max(axis=1, keepdims=True), 1e-12)
    import jax

    clf = train_classifier(jax.random.PRNGKey(0), layout, spectra, cs,
                           mtrain.check_bits_for_codes(layout, cs),
                           ClassifierConfig(check_train_steps=30))

    import jax as _jax

    if len(_jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    samples = []
    for i in range(4):
        fov = synthetic.make_fov(layout, codes, shape=(96, 96), seed=i,
                                 cell_axes=(6.0, 9.0))
        paths = []
        for li, plane in enumerate(fov["stack"]):
            p = tmp_path / f"s{i}_laser{li}.npy"
            np.save(p, plane)
            paths.append(str(p))
        samples.append((f"s{i}", paths))

    # fail the first full-batch dispatch once, then behave
    orig = fov_batch.batched_fov_step
    state = {"fails": 0}

    def wrap(mesh, cfg, max_cells, clf_static, denoise):
        real_run = orig(mesh, cfg, max_cells, clf_static, denoise)

        def run(batched, clf_arrays):
            if batched[0].shape[0] == 4 and state["fails"] == 0:
                state["fails"] += 1
                raise FakeOom()
            return real_run(batched, clf_arrays)

        return run

    monkeypatch.setattr(fov_batch, "batched_fov_step", wrap)
    from hiprfish_tpu.parallel import mesh as meshlib

    mesh = meshlib.make_mesh(2, fov=2, tile=1)
    cfg = SegmentationConfig(watershed_max_iters=64, ccl_max_iters=64,
                             kmeans_iters=10, lp_cell_min_size=20)
    res = fov_batch.run_batch_pipeline(
        samples, clf, cfg, max_cells=64, batch=4, mesh=mesh,
        denoise=False, out_dir=str(tmp_path))
    assert state["fails"] == 1
    assert set(res) == {f"s{i}" for i in range(4)}
    for i in range(4):
        assert (tmp_path / f"s{i}_avgint.csv").exists()
        assert (tmp_path / f"s{i}_cell_ids.txt").exists()


def test_measure_streamed_backs_off_z_chunk(rng):
    """measure_volume_streamed retries the whole accumulation at halved
    slab depth when a slab OOMs (measured on-chip 2026-08-18: at full
    2020x2020x170 scale a z_chunk=4 streamed sweep itself exhausted HBM
    after the fused measure already had — the ladder is the only way the
    measurement stage survives)."""
    import jax.numpy as jnp

    from hiprfish_tpu.pipeline import segment3d

    x = y = 16
    z, c, max_cells = 5, 3, 8
    seg = rng.randint(0, max_cells, (x, y, z)).astype(np.int32)
    vol = rng.rand(x, y, z, c).astype(np.float32)

    calls = []

    def loader(z0, zc):
        calls.append(zc)
        if zc > 1:
            raise FakeOom()
        return vol[:, :, z0:z0 + zc, :]

    got = np.asarray(segment3d.measure_volume_streamed(
        jnp.asarray(seg), loader, z, 4, c, max_cells))

    assert 4 in calls and 2 in calls  # walked 4 -> 2 -> 1
    want = np.zeros((max_cells, c), np.float32)
    for lbl in range(max_cells):
        m = seg == lbl
        if m.any():
            want[lbl] = vol[m].mean(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_measure_streamed_backs_off_z_chunk_channels_major(rng):
    """Same ladder on the channels-major layout ((C, zc, X, Y) slabs)."""
    import jax.numpy as jnp

    from hiprfish_tpu.pipeline import segment3d

    x = y = 16
    z, c, max_cells = 5, 3, 8
    seg = rng.randint(0, max_cells, (x, y, z)).astype(np.int32)
    vol = rng.rand(x, y, z, c).astype(np.float32)
    vol_cm = vol.transpose(3, 2, 0, 1)  # (C, Z, X, Y)

    def loader(z0, zc):
        if zc > 1:
            raise FakeOom()
        return vol_cm[:, z0:z0 + zc]

    got = np.asarray(segment3d.measure_volume_streamed(
        jnp.asarray(seg), loader, z, 4, c, max_cells, channels_major=True))

    want = np.zeros((max_cells, c), np.float32)
    for lbl in range(max_cells):
        m = seg == lbl
        if m.any():
            want[lbl] = vol[m].mean(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
