"""Tests for auxiliary components: neighbor_average, full 3D profiles,
prefetch loader, metrics oracle, summarize plots, logging."""

import numpy as np
import jax.numpy as jnp

from hiprfish_tpu.config import SEVEN_BIT
from hiprfish_tpu.models import metrics
from hiprfish_tpu.ops import line_profile as lp


def test_neighbor_average_matches_numpy(rng):
    patch = 5
    vol = rng.rand(4 + 4 * (patch - 1), 5 + 4 * (patch - 1),
                   3 + 4 * (patch - 1)).astype(np.float32)
    # numpy oracle: mean over (2s+1)^3 window centered at offset patch-1
    pad = 2 * (patch - 1)
    x, y, z = vol.shape[0] - pad, vol.shape[1] - pad, vol.shape[2] - pad
    got = np.asarray(lp.neighbor_average(jnp.asarray(vol), patch))
    c = patch - 1
    for s in (1, patch - 1):
        want = np.zeros((x, y, z))
        for i in range(x):
            for j in range(y):
                for k in range(z):
                    w = vol[i + c - s:i + c + s + 1,
                            j + c - s:j + c + s + 1,
                            k + c - s:k + c + s + 1]
                    want[i, j, k] = w.mean()
        np.testing.assert_allclose(got[..., s - 1], want, rtol=2e-4)


def test_line_profile_3d_full_shape(rng):
    vol = rng.rand(16, 15, 14).astype(np.float32)
    out = np.asarray(lp.line_profile_3d_full(jnp.asarray(vol), 11, 9, 9))
    assert out.shape == (6, 5, 4, 72, 11)
    # center sample equals the voxel value
    center_tbl = lp.line_table_3d(11, 9, 9)
    assert np.all(center_tbl[:, 5, :] == 5)
    np.testing.assert_allclose(out[..., 0, 5], vol[5:11, 5:10, 5:9], rtol=1e-6)


def _scalar_gated_cosine(x, y, blocks, check_slice):
    """Direct per-pair oracle of the reference metric semantics
    (train_reference.py:223-386)."""
    clo, chi = check_slice
    agree = np.abs(x[clo:chi] - y[clo:chi]).sum() < 0.01
    dists = []
    for b, (lo, hi) in enumerate(blocks):
        xb, yb = x[lo:hi], y[lo:hi]
        nx, ny = np.linalg.norm(xb), np.linalg.norm(yb)
        if nx == 0 and ny == 0:
            d = 0.0
        elif nx == 0 or ny == 0:
            d = 1.0
        else:
            d = 1.0 - float(xb @ yb / (nx * ny))
        if agree and x[clo + b] == 0:
            d = 0.0
        dists.append(d)
    return sum(dists) / len(blocks)


def test_block_cosine_matrix_matches_scalar_oracle(rng):
    blocks, check_slice = metrics.metric_for_layout(SEVEN_BIT)
    n_checks = check_slice[1] - check_slice[0]
    d = SEVEN_BIT.n_channels + n_checks
    x = rng.rand(6, d).astype(np.float32)
    y = rng.rand(5, d).astype(np.float32)
    x[:, check_slice[0]:] = rng.randint(0, 2, (6, n_checks))
    y[:, check_slice[0]:] = rng.randint(0, 2, (5, n_checks))
    got = np.asarray(metrics.block_cosine_distance_matrix(
        jnp.asarray(x), jnp.asarray(y), blocks, check_slice))
    for i in range(6):
        for j in range(5):
            want = _scalar_gated_cosine(x[i], y[j], blocks, check_slice)
            np.testing.assert_allclose(got[i, j], want, atol=1e-5)


def test_fov_prefetcher(tmp_path, rng):
    from hiprfish_tpu.io.loader import FovPrefetcher

    fovs = []
    for i in range(3):
        files = []
        for laser in ("488", "514"):
            p = tmp_path / f"s{i}_{laser}.npy"
            np.save(p, rng.rand(8, 8, 3).astype(np.float32))
            files.append(str(p))
        fovs.append((f"s{i}", files))
    got = list(FovPrefetcher(fovs, depth=2))
    assert [k for k, _ in got] == ["s0", "s1", "s2"]
    assert got[0][1][0].shape == (8, 8, 3)


def test_runlog_stages():
    from hiprfish_tpu.utils.logging import RunLog
    import io

    log = RunLog(stream=io.StringIO())
    with log.stage("measure", sample="a"):
        pass
    with log.stage("measure", sample="b"):
        pass
    s = log.summary()
    assert s["measure"]["count"] == 2


def test_summarize_plots(tmp_path, rng):
    import pandas as pd
    from hiprfish_tpu.pipeline import summarize

    ab = pd.DataFrame({
        "Barcodes": np.arange(1, 1024),
        "FOV1": rng.randint(0, 5, 1023),
        "FOV2": rng.randint(0, 5, 1023),
    })
    p = tmp_path / "x_results_abundance.csv"
    ab.to_csv(p, index=False)
    summarize.plot_mean_abundance_barcodes(str(p), str(tmp_path / "a.pdf"))
    summarize.plot_mean_abundance_distribution(str(p), str(tmp_path / "b.pdf"))
    summarize.plot_avg_int_reference(rng.rand(20, 95), 37,
                                     str(tmp_path / "c.pdf"))
    assert (tmp_path / "a.pdf").exists()
    assert (tmp_path / "c.pdf").exists()
    m, sd = summarize.bootstrap_estimate_mean(rng.rand(50), 200)
    assert 0.3 < m < 0.7


def test_czi_native_decoder(tmp_path, rng):
    from hiprfish_tpu.io import czi, czi_native

    plane = rng.rand(64, 72, 4).astype(np.float32)
    path = str(tmp_path / "n.czi")
    czi.write_czi(path, plane)
    lib = czi_native.get_library()
    if lib is None:
        import pytest

        pytest.skip("native library unavailable")
    out = czi_native.load_plane_native(czi.CziFile(path))
    np.testing.assert_allclose(out, plane, rtol=1e-6)


def test_read_cell_information_schemas(tmp_path, rng):
    """Layout-derived column indexing of summarize._read_cell_information:
    headerless 7-bit files (classify_spectra.py schema), files with _error
    barcode calls, and named biofilm files with probability columns."""
    import pandas as pd
    from hiprfish_tpu.pipeline.summarize import _read_cell_information

    # Headerless 7-bit: 63 spectra + 4 checks + barcode + 9 metadata cols.
    n = 12
    spectra = rng.rand(n, 63)
    checks = rng.randint(0, 2, (n, 4)).astype(float)
    codes = ["0101010"] * (n - 1) + ["0101011_error"]
    meta = np.column_stack([
        np.array(["s"] * n), np.arange(1, n + 1),
        rng.rand(n), rng.rand(n), rng.rand(n), rng.rand(n),
        rng.rand(n), rng.rand(n), rng.randint(60, 900, n)])
    df = pd.DataFrame(np.column_stack(
        [spectra, checks, np.array(codes)[:, None], meta]))
    p7 = tmp_path / "a_7b_cell_information.csv"
    df.to_csv(p7, index=None, header=None)
    barcodes, spec = _read_cell_information(str(p7), 7)
    assert list(barcodes) == codes
    assert spec.shape == (n, 63)
    np.testing.assert_allclose(spec.values, spectra, rtol=1e-5)

    # Named biofilm schema with per-class probability columns.
    bio = pd.DataFrame(rng.rand(n, 63),
                       columns=[f"channel_{i}" for i in range(63)])
    for c in range(4):
        bio[f"check_{c}"] = checks[:, c]
    bio["cell_barcode"] = "0011001"
    bio["max_probability"] = rng.rand(n)
    bio["0011001_prob"] = rng.rand(n)
    bio["0101010_prob"] = rng.rand(n)
    bio["sample"] = "s"
    bio["area"] = rng.randint(60, 900, n)
    pb = tmp_path / "b_cell_information.csv"
    bio.to_csv(pb, index=None)
    barcodes, spec = _read_cell_information(str(pb), 7)
    assert (barcodes == "0011001").all()
    assert spec.shape == (n, 63)


def test_plot_representative_cell_spectra(tmp_path, rng):
    """Per-taxon spectra grid (analyze_multispecies_images.py:123-201):
    stats discovered from the cell_information naming convention; PDF
    rendered; means match the file contents."""
    import pandas as pd
    from hiprfish_tpu.pipeline import summarize

    taxids = [564, 1718]
    base = {t: rng.rand(63) for t in taxids}
    for enc_set in ("A", "B"):
        for t in taxids:
            n = 10
            spectra = base[t][None, :] + rng.randn(n, 63) * 0.01
            checks = rng.randint(0, 2, (n, 4)).astype(float)
            meta = np.column_stack([
                np.array(["s"] * n), np.arange(1, n + 1),
                rng.rand(n), rng.rand(n), rng.rand(n), rng.rand(n),
                rng.rand(n), rng.rand(n), rng.randint(60, 900, n)])
            df = pd.DataFrame(np.column_stack(
                [spectra, checks, np.array(["0101010"] * n)[:, None], meta]))
            df.to_csv(tmp_path / f"x_{enc_set}_{t}_fov_1_cell_information.csv",
                      index=None, header=None)
    out = tmp_path / "grid.pdf"
    stats = summarize.plot_representative_cell_spectra(
        str(tmp_path), encoding_sets=("A", "B"),
        set_titles=("Random", "Least Complex"), output_pdf=str(out))
    assert out.exists()
    assert set(stats) == {(e, t) for e in ("A", "B") for t in taxids}
    mean_a_564 = stats[("A", 564)][0]
    np.testing.assert_allclose(mean_a_564, base[564], atol=0.02)
