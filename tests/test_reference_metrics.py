"""Exact matrix forms of the reference's pickled UMAP metrics
(models/metrics.reference_metric_matrix) vs direct scalar transcriptions of
the numba sources (train_reference.py:224/:569/:913/:994/:1169), and the
legacy-stack loader's metric resolution (ADVICE r2 high)."""

import pickle
import sys
import types

import numpy as np
import pytest

from hiprfish_tpu.models import metrics, umap_infer


def _cos_dist(x, y):
    nx, ny = np.sqrt(np.sum(x * x)), np.sqrt(np.sum(y * y))
    if nx == 0.0 and ny == 0.0:
        return 0.0
    if nx == 0.0 or ny == 0.0:
        return 1.0
    return 1.0 - float(np.dot(x, y) / (nx * ny))


def _scalar_gated(x, y, blocks, check_slice, gate_bits, scale, disagree):
    clo, chi = check_slice
    if np.sum(np.abs(x[clo:chi] - y[clo:chi])) >= 0.01:
        if disagree == "one":
            return 1.0
        # violet_derivative_v2 disagree branch (train_reference.py:663-731)
        return (1.0 + sum(_cos_dist(x[lo:hi], y[lo:hi])
                          for lo, hi in blocks)) / (len(blocks) + 1)
    total = 0.0
    for b, (lo, hi) in enumerate(blocks):
        g = gate_bits[b]
        if g is not None and x[clo + g] == 0:
            continue
        total += _cos_dist(x[lo:hi], y[lo:hi])
    n = len(blocks) + (1 if disagree == "ungated_deriv1" else 0)
    return scale * total / n


def _random_features(rng, n, d, check_slice, n_blocks):
    clo, chi = check_slice
    f = rng.rand(n, d).astype(np.float32)
    f[:, clo:chi] = (rng.rand(n, chi - clo) > 0.4).astype(np.float32)
    # make some block slices exactly zero to hit the zero-norm branches
    f[: n // 4, : min(23, d)] = 0.0
    return f


CASES = [
    ("channel_cosine_intensity", 100, metrics._REF_BLOCKS_10B, (95, 100),
     (0, 1, 2, None, None), 1.0, "one"),
    ("channel_cosine_intensity_violet_derivative_v2", 132,
     metrics._REF_BLOCKS_10B, (126, 132), (0, 1, 2, 3, 4), 1.0,
     "ungated_deriv1"),
    ("channel_cosine_intensity_7b", 67, metrics._REF_BLOCKS_7B, (63, 67),
     (0, 1, 2, 3), 1.0, "one"),
    ("channel_cosine_intensity_7b_v2", 67, metrics._REF_BLOCKS_7B, (63, 67),
     (0, 1, 2, 3), 0.5, "one"),
]


@pytest.mark.parametrize("name,d,blocks,cs,gates,scale,mode",
                         CASES, ids=[c[0] for c in CASES])
def test_reference_metric_matches_scalar_transcription(
        name, d, blocks, cs, gates, scale, mode):
    rng = np.random.RandomState(3)
    q = _random_features(rng, 12, d, cs, len(blocks))
    r = _random_features(rng, 17, d, cs, len(blocks))
    # force several exact check agreements
    r[:6, cs[0]:cs[1]] = q[:6 % q.shape[0], cs[0]:cs[1]][: 6]
    got = np.asarray(metrics.reference_metric_matrix(name)(q, r))
    want = np.array([[_scalar_gated(x, y, blocks, cs, gates, scale, mode)
                      for y in r] for x in q])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_chi_metric_matches_scalar():
    rng = np.random.RandomState(4)
    q = _random_features(rng, 8, 67, (63, 67), 4)
    r = _random_features(rng, 9, 67, (63, 67), 4)
    r[:4, 63:67] = q[:4, 63:67]
    got = np.asarray(metrics.reference_metric_matrix(
        "channel_chi_intensity_7b")(q, r))
    for i, x in enumerate(q):
        for j, y in enumerate(r):
            if np.sum(np.abs(x[63:67] - y[63:67])) >= 0.01:
                want = 1.0
            else:
                want = float(np.sum((x[:63] - y[:63]) ** 2
                                    / np.maximum(x[:63] + y[:63], 1e-30))) / 63
            assert abs(got[i, j] - want) < 1e-5


def test_resolve_metric_fn_rejects_unknown_and_maps_known():
    model = umap_infer.UmapModel(
        raw_data=np.zeros((4, 67), np.float32),
        embedding=np.zeros((4, 2), np.float32),
        a=1.6, b=0.9, n_neighbors=3,
        metric="channel_cosine_intensity_7b_v2")
    fn = umap_infer.resolve_metric_fn(model, None)
    assert fn is not None
    model_eu = model._replace(metric="euclidean")
    assert umap_infer.resolve_metric_fn(model_eu, None) is None
    model_bad = model._replace(metric="mahalanobis")
    with pytest.raises(ValueError, match="mahalanobis"):
        umap_infer.resolve_metric_fn(model_bad, None)


def test_loader_records_numba_stub_metric_name(tmp_path):
    """A pickled UMAP whose metric is a numba dispatcher (pickled by module
    reference) must surface the function NAME so resolve_metric_fn can map
    it — the production artifacts all record one (train_reference.py:1457)."""
    mod = types.ModuleType("umap")
    sub = types.ModuleType("umap.umap_")

    class UMAP:
        pass

    UMAP.__module__ = "umap.umap_"
    UMAP.__qualname__ = "UMAP"
    sub.UMAP = UMAP
    mod.umap_ = sub

    train_mod = types.ModuleType("hiprfish_imaging_train_reference")

    def channel_cosine_intensity_7b_v2(x, y):
        raise AssertionError("never called at load time")

    channel_cosine_intensity_7b_v2.__module__ = \
        "hiprfish_imaging_train_reference"
    channel_cosine_intensity_7b_v2.__qualname__ = \
        "channel_cosine_intensity_7b_v2"
    train_mod.channel_cosine_intensity_7b_v2 = channel_cosine_intensity_7b_v2

    obj = UMAP()
    obj._raw_data = np.zeros((5, 67), np.float32)
    obj.embedding_ = np.zeros((5, 2), np.float32)
    obj._a, obj._b = 1.6, 0.9
    obj.n_neighbors = 3
    obj.metric = channel_cosine_intensity_7b_v2

    path = tmp_path / "umap_transform.pkl"
    sys.modules["umap"] = mod
    sys.modules["umap.umap_"] = sub
    sys.modules["hiprfish_imaging_train_reference"] = train_mod
    try:
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    finally:
        for m in ("umap", "umap.umap_", "hiprfish_imaging_train_reference"):
            sys.modules.pop(m, None)

    model = umap_infer.load_umap_pickle(str(path))
    assert model.metric == "channel_cosine_intensity_7b_v2"
    assert umap_infer.resolve_metric_fn(model, None) is not None


def test_knn_top_k_calls_match_approx_max_k(monkeypatch):
    """The kNN vote selects neighbours with exact lax.top_k; the
    approx_max_k it replaced must give identical calls."""
    import jax
    import jax.numpy as jnp

    from hiprfish_tpu.models import classifier as C

    rng = np.random.RandomState(0)
    blocks = ((0, 8), (8, 14), (14, 20))
    train = rng.rand(300, 23).astype(np.float32)
    train[:, 20:] = rng.randint(0, 2, (300, 3))
    labels = rng.randint(0, 12, 300).astype(np.int32)
    q = train[rng.randint(0, 300, 64)] + 0.01 * rng.randn(64, 23).astype(
        np.float32)
    q[:, 20:] = np.round(q[:, 20:])
    args = (jnp.asarray(q), jnp.asarray(train), jnp.asarray(labels), 12,
            blocks, (20, 23), 7, 30.0)
    exact = C._knn_predict(*args)

    def approx(x, k):
        return jax.lax.approx_max_k(x, k, recall_target=0.999)

    monkeypatch.setattr(jax.lax, "top_k", approx)
    approx_fn = jax.jit(C._knn_predict.__wrapped__,
                        static_argnums=(3, 4, 5, 6, 7))
    got = approx_fn(*args)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(exact[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(exact[1]),
                               rtol=1e-6)
