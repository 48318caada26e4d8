"""Device inference path for legacy UMAP classifier artifacts.

The reference's flagship classification stack is a trio of joblib pickles
(hiprfish_imaging_image_classification.py:44-56): a fitted ``umap.UMAP``
(``*_umap_transform.pkl``), an RBF SVC over its 2-D embedding
(``*_umap_transformed_svc.pkl``), and six per-laser check SVCs
(``*_umap_transformed_check_svc.pkl``). At inference the reference calls
``umap_transform.transform(features)`` — kNN against the training data under
the custom spectral metric, followed by SGD placement in the fixed training
embedding — then ``clf_umap.predict`` on the embedded points.

This module re-expresses that whole path as JAX array programs:

  * ``load_umap_pickle`` unpickles the artifact WITHOUT umap-learn installed
    (a permissive unpickler substitutes inert stubs for any unimportable
    class — umap, pynndescent, numba closures) and extracts the arrays the
    transform actually needs: ``_raw_data``, ``embedding_``, the fitted
    output-curve coefficients ``_a``/``_b``, and ``n_neighbors``.
  * ``umap_transform`` implements the public UMAP transform algorithm
    (McInnes et al. 2018, umap_.UMAP.transform): exact kNN as one distance
    GEMM + top_k, the smooth-kNN calibration (rho/sigma binary search
    targeting log2(k)), initialization at the membership-weighted mean of
    neighbor embeddings, then ``n_epochs`` of attractive/repulsive layout
    optimization against the FROZEN training embedding. One deliberate
    deviation, chosen for the hardware: per-edge Bernoulli sampling
    (epochs_per_sample scheduling) is replaced by its expectation —
    every edge applies its gradient each epoch scaled by w/w_max — which
    vectorizes the whole epoch into two GEMM-shaped updates instead of a
    sequential per-edge scalar loop. Cluster assignments (what the SVC
    consumes) are preserved; exact per-point jitter is not.

Parity caveat, stated honestly: umap-learn cannot run in this environment,
so tests validate the loader against structurally-identical synthetic
pickles and the transform against its mathematical contract (training
points re-embed onto themselves; held-out spectra land in their class's
cluster and the downstream SVC recovers their barcode), not bit-for-bit
against umap-learn output.
"""

from __future__ import annotations

import functools
import io
import pickle
from typing import Callable, NamedTuple, Sequence

import numpy as np

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Permissive unpickling (no umap-learn / pynndescent / numba required)
# ---------------------------------------------------------------------------


class _Stub:
    """Inert stand-in for any class the environment cannot import.

    Accepts every pickle reconstruction protocol (__setstate__ with dict or
    tuple state, attribute assignment, item assignment) and records the
    original module/qualname for introspection."""

    _stub_target = "?"

    def __init__(self, *args, **kwargs):
        self._stub_args = args
        self._stub_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)
        else:
            self._stub_state = state

    def __repr__(self):
        return f"<stub {self._stub_target}>"


class _PermissiveUnpickler(pickle.Unpickler):
    """Unpickler that substitutes ``_Stub`` subclasses for unimportable
    globals instead of raising — joblib/pickle artifacts from richer
    environments load with their array payloads intact."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,),
                        {"_stub_target": f"{module}.{name}"})


def permissive_load(path: str):
    """Load a pickle (or joblib zlib-wrapped pickle) with stub substitution."""
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x80" or head[:1] == b"(":  # plain pickle
            return _PermissiveUnpickler(f).load()
        data = f.read()
    # joblib's legacy format embeds a plain pickle after a header; the
    # modern format IS a plain pickle with custom array framing, which the
    # permissive unpickler handles because joblib itself is importable.
    return _PermissiveUnpickler(io.BytesIO(data)).load()


class UmapModel(NamedTuple):
    raw_data: np.ndarray     # (N, D) training features
    embedding: np.ndarray    # (N, E) fitted embedding (frozen at transform)
    a: float                 # output-curve coefficient
    b: float                 # output-curve coefficient
    n_neighbors: int
    metric: str              # metric name recorded in the artifact


def _get(obj, *names, default=None):
    for n in names:
        if hasattr(obj, n):
            return getattr(obj, n)
        if isinstance(obj, dict) and n in obj:
            return obj[n]
    return default


def load_umap_pickle(path: str) -> UmapModel:
    """Extract the transform-relevant arrays from a pickled fitted UMAP.

    Works on artifacts produced by joblib.dump(umap.UMAP().fit(...)) in the
    reference's training environment (train_reference.py:1415-1423) without
    umap-learn present here."""
    obj = permissive_load(path)
    raw = _get(obj, "_raw_data", "raw_data")
    emb = _get(obj, "embedding_", "embedding")
    if raw is None or emb is None:
        raise ValueError(
            f"{path} does not look like a fitted UMAP artifact "
            f"(missing _raw_data/embedding_); got {type(obj)!r}")
    a = _get(obj, "_a", "a")
    b = _get(obj, "_b", "b")
    if a is None or b is None:
        # umap's fitted defaults for min_dist=0.1, spread=1.0
        a, b = 1.577, 0.8951
    metric = _get(obj, "metric", default="euclidean")
    if not isinstance(metric, str):
        # numba dispatchers pickle by reference; the permissive unpickler
        # turns them into stub classes/instances named after the function
        metric = getattr(metric, "__name__", None) \
            or getattr(type(metric), "__name__", "euclidean")
    return UmapModel(
        raw_data=np.asarray(raw, np.float32),
        embedding=np.asarray(emb, np.float32),
        a=float(a), b=float(b),
        n_neighbors=int(_get(obj, "n_neighbors", default=15) or 15),
        metric=str(metric),
    )


# ---------------------------------------------------------------------------
# The transform itself
# ---------------------------------------------------------------------------


def _euclidean_distance_matrix(x, y):
    x2 = jnp.sum(x * x, axis=1, keepdims=True)
    y2 = jnp.sum(y * y, axis=1)[None, :]
    d2 = x2 + y2 - 2.0 * jnp.dot(x, y.T,
                                 preferred_element_type=jnp.float32)
    return jnp.sqrt(jnp.maximum(d2, 0.0))


def _smooth_knn_weights(knn_d, n_neighbors, n_iter: int = 64,
                        local_connectivity: float = 1.0,
                        bandwidth: float = 1.0):
    """rho/sigma calibration of umap.smooth_knn_dist + membership strengths.

    knn_d: (Q, k) ascending neighbor distances. Returns (Q, k) weights."""
    target = jnp.log2(jnp.float32(n_neighbors)) * bandwidth
    # rho: distance to the local_connectivity-th nearest *nonzero* neighbor
    nz = jnp.where(knn_d > 0.0, knn_d, jnp.inf)
    idx = int(np.ceil(local_connectivity)) - 1
    rho = jnp.sort(nz, axis=1)[:, idx]
    rho = jnp.where(jnp.isfinite(rho), rho, 0.0)

    def psum(sigma):
        z = jnp.maximum(knn_d - rho[:, None], 0.0)
        return jnp.sum(jnp.exp(-z / sigma[:, None]), axis=1)

    lo = jnp.zeros(knn_d.shape[0], jnp.float32)
    hi = jnp.full(knn_d.shape[0], np.inf, jnp.float32)
    mid = jnp.ones(knn_d.shape[0], jnp.float32)

    def body(_, state):
        lo, hi, mid = state
        val = psum(mid)
        too_big = val > target
        hi = jnp.where(too_big, mid, hi)
        lo = jnp.where(too_big, lo, mid)
        mid = jnp.where(too_big, (lo + hi) / 2.0,
                        jnp.where(jnp.isinf(hi), mid * 2.0, (lo + hi) / 2.0))
        return lo, hi, mid

    _, _, sigma = jax.lax.fori_loop(0, n_iter, body, (lo, hi, mid))
    # umap clamps sigma to a fraction of the mean distance
    mean_d = jnp.mean(knn_d)
    sigma = jnp.maximum(sigma, 1e-3 * mean_d)
    w = jnp.exp(-jnp.maximum(knn_d - rho[:, None], 0.0) / sigma[:, None])
    return w


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _transform_impl(dmat, train_emb, key, ab, n_neighbors, n_epochs,
                    initial_alpha, negative_sample_rate):
    q = dmat.shape[0]
    neg_d, knn_idx = jax.lax.top_k(-dmat, n_neighbors)
    knn_d = -neg_d                                       # (Q, k) ascending
    w = _smooth_knn_weights(knn_d, n_neighbors)          # (Q, k)
    wn = w / jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1e-12)
    nbr_emb = jnp.take(train_emb, knn_idx, axis=0)       # (Q, k, E)
    emb = jnp.sum(wn[:, :, None] * nbr_emb, axis=1)      # init (Q, E)
    w_max = jnp.maximum(jnp.max(w), 1e-12)
    edge_w = w / w_max                                   # expected step scale

    n_train = train_emb.shape[0]

    def epoch(carry, e):
        emb, key = carry
        alpha = initial_alpha * (1.0 - e / jnp.float32(n_epochs))
        # Attractive forces toward every kNN edge, expectation-weighted.
        diff = emb[:, None, :] - nbr_emb                 # (Q, k, E)
        d2 = jnp.sum(diff * diff, axis=-1)
        # grad coeff of -log phi: 2ab d^(2(b-1)) / (1 + a d^(2b))
        a, b = ab[0], ab[1]
        coeff = (-2.0 * a * b * jnp.power(jnp.maximum(d2, 1e-12), b - 1.0)
                 / (1.0 + a * jnp.power(jnp.maximum(d2, 1e-12), b)))
        grad = jnp.clip(coeff[:, :, None] * diff, -4.0, 4.0)
        emb = emb + alpha * jnp.sum(edge_w[:, :, None] * grad, axis=1)
        # Repulsive forces from random training points.
        key, sub = jax.random.split(key)
        n_neg = negative_sample_rate
        neg_idx = jax.random.randint(sub, (q, n_neg), 0, n_train)
        neg_emb = jnp.take(train_emb, neg_idx, axis=0)   # (Q, n_neg, E)
        diffn = emb[:, None, :] - neg_emb
        d2n = jnp.sum(diffn * diffn, axis=-1)
        coeffn = (2.0 * b
                  / ((0.001 + d2n)
                     * (1.0 + a * jnp.power(jnp.maximum(d2n, 1e-12), b))))
        gradn = jnp.clip(coeffn[:, :, None] * diffn, -4.0, 4.0)
        emb = emb + alpha * jnp.mean(gradn, axis=1)
        return (emb, key), None

    (emb, _), _ = jax.lax.scan(epoch, (emb, key),
                               jnp.arange(n_epochs, dtype=jnp.float32))
    return emb, knn_idx, knn_d


def umap_transform(model: UmapModel, query,
                   distance_fn: Callable | None = None,
                   n_epochs: int = 30, initial_alpha: float = 1.0,
                   negative_sample_rate: int = 5,
                   key=None) -> jnp.ndarray:
    """Embed ``query`` (Q, D) into a fitted UMAP's space (Q, E).

    distance_fn(query, raw_data) -> (Q, N) must match the metric the model
    was trained with; defaults to euclidean. For the reference's spectral
    metric pass a closure over metrics.block_cosine_distance_matrix
    (channel_cosine_intensity, train_reference.py:1415)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    x = jnp.asarray(query, jnp.float32)
    y = jnp.asarray(model.raw_data, jnp.float32)
    dmat = (distance_fn(x, y) if distance_fn is not None
            else _euclidean_distance_matrix(x, y))
    k = min(model.n_neighbors, model.raw_data.shape[0])
    ab = jnp.asarray([model.a, model.b], jnp.float32)
    emb, _, _ = _transform_impl(
        dmat, jnp.asarray(model.embedding), key, ab, k, int(n_epochs),
        float(initial_alpha), int(negative_sample_rate))
    return emb


# ---------------------------------------------------------------------------
# The full legacy stack (umap + embedded SVC + check SVCs)
# ---------------------------------------------------------------------------


def resolve_metric_fn(model: UmapModel, distance_fn: Callable | None):
    """Distance function for a loaded UMAP artifact.

    The reference fits its UMAPs under custom gated block-cosine numba
    metrics (train_reference.py:1415/1457/1511) — scoring a real artifact
    under euclidean silently reorders neighbors and corrupts barcode calls,
    so an unknown recorded metric is an error, not a fallback."""
    if distance_fn is not None:
        return distance_fn
    name = model.metric
    if name in ("euclidean", "l2"):
        return None
    from hiprfish_tpu.models import metrics

    try:
        return metrics.reference_metric_matrix(name)
    except KeyError:
        raise ValueError(
            f"UMAP artifact was fitted with metric {name!r}, which has no "
            f"matrix equivalent (models/metrics.py:"
            f"reference_metric_matrix). Pass distance_fn= explicitly to "
            f"override.") from None


class LegacyUmapClassifier(NamedTuple):
    """The reference's pickled classifier stack, scored on the device.

    predict mirrors image_classification.py:44-56 (10-bit, 3 pickles) and
    classify_spectra.py:23-35 (7-bit, 4 pickles incl. StandardScaler; the
    check SVCs there consume SCALED spectra): check SVCs populate the
    check-bit feature columns, the UMAP transform embeds the result, the
    embedding SVC emits barcode strings."""

    umap: UmapModel
    svc_embed: "object"                  # JaxRbfSvc over the embedding
    check_svcs: Sequence["object"]       # per-laser-block JaxRbfSvc list
    blocks: Sequence[tuple]              # feature slices per check SVC
    distance_fn: Callable | None = None
    scaler_mean: "object" = None         # StandardScaler params (7-bit)
    scaler_scale: "object" = None
    n_base: int | None = None            # spectral columns the scaler covers

    def check_inputs(self, x):
        if self.scaler_mean is None:
            return x
        base = x[:, : self.n_base]
        scaled = (base - self.scaler_mean) / self.scaler_scale
        return np.concatenate(
            [scaled, x[:, self.n_base:]], axis=1).astype(np.float32)

    def predict(self, features, n_epochs: int = 30, key=None,
                return_checks: bool = False):
        x = np.asarray(features, np.float32).copy()
        n_blocks = len(self.check_svcs)
        base = x.shape[1] - n_blocks
        xs = self.check_inputs(x)
        for i, (svc, (lo, hi)) in enumerate(zip(self.check_svcs,
                                                self.blocks)):
            x[:, base + i] = np.asarray(
                svc.predict(xs[:, lo:hi])).astype(np.float32)
        emb = umap_transform(self.umap, x, distance_fn=self.distance_fn,
                             n_epochs=n_epochs, key=key)
        pred = self.svc_embed.predict(np.asarray(emb))
        if return_checks:
            return pred, x
        return pred


def load_legacy_umap_stack(transform_path: str,
                           blocks: Sequence[tuple] | None = None,
                           distance_fn: Callable | None = None
                           ) -> LegacyUmapClassifier:
    """Load the reference's umap_transform / transformed_svc /
    transformed_check_svc pickle trio by the reference's naming convention
    (image_classification.py:44-46)."""
    import re

    from hiprfish_tpu.models.artifacts import load_reference_svc

    svc_path = re.sub("transform.pkl", "transformed_svc.pkl", transform_path)
    check_path = re.sub("transform.pkl", "transformed_check_svc.pkl",
                        transform_path)
    umap_model = load_umap_pickle(transform_path)
    svc = load_reference_svc(svc_path)
    checks = load_reference_svc(check_path)
    if not isinstance(checks, list):
        checks = [checks]
    if blocks is None:
        # 10-bit + violet-derivative layout (image_classification.py:49-54)
        blocks = [(0, 32), (32, 55), (55, 75), (75, 89), (89, 95), (95, 126)]
    return LegacyUmapClassifier(umap_model, svc, checks, tuple(blocks),
                                resolve_metric_fn(umap_model, distance_fn))


def load_legacy_umap_stack_7b(transform_path: str,
                              distance_fn: Callable | None = None
                              ) -> LegacyUmapClassifier:
    """The 7-bit biofilm artifact quartet (umap transform + scaler +
    embedded SVC + 4 check SVCs) by the reference's naming convention
    (classify_spectra.py:56-59); check SVCs read scaled 63-channel blocks."""
    import re

    from hiprfish_tpu.models.artifacts import load_reference_svc

    def sub(tail):
        return re.sub("transform_biofilm_7b.pkl", tail, transform_path)

    umap_model = load_umap_pickle(transform_path)
    try:  # sklearn is importable, so joblib handles its own framing
        import joblib

        scaler = joblib.load(sub("transformed_biofilm_7b_scaler.pkl"))
    except Exception:
        scaler = permissive_load(sub("transformed_biofilm_7b_scaler.pkl"))
    svc = load_reference_svc(sub("transformed_biofilm_7b_svc.pkl"))
    checks = load_reference_svc(sub("transformed_biofilm_7b_check_svc.pkl"))
    if not isinstance(checks, list):
        checks = [checks]
    blocks = [(0, 23), (23, 43), (43, 57), (57, 63)]
    return LegacyUmapClassifier(
        umap_model, svc, checks, tuple(blocks),
        resolve_metric_fn(umap_model, distance_fn),
        scaler_mean=np.asarray(_get(scaler, "mean_"), np.float32),
        scaler_scale=np.asarray(_get(scaler, "scale_"), np.float32),
        n_base=63)
