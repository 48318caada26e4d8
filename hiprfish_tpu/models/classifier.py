"""Spectral barcode classifier (replaces UMAP.transform + SVC).

The reference classifies per-cell spectra by (a) predicting per-laser-block
"check bits" with per-block RBF SVCs, (b) embedding the (spectrum + check
bits) feature vector with a supervised UMAP transform under a custom gated
block-cosine metric, and (c) an RBF SVC over the 2-D embedding
(image_classification.py:38-72, train_reference.py:2037-2044). UMAP.transform
is approximate kNN against the training set under that metric followed by an
optimization — so the decision structure is fundamentally "metric-space
nearest neighbors". Here that structure is implemented directly, as
dense matrix work:

  * check bits: small MLP heads per block trained with optax (sigmoid
    probability, threshold 0.5) — replaces svm.SVC(C=10, gamma=0.5) per block;
  * barcode: temperature-softmax k-NN vote (k = n_neighbors = 25) under the
    same gated block-cosine metric, computed as a handful of GEMMs against
    the stored training matrix (models/metrics.py). The vote fractions give
    calibrated per-class probabilities (predict_proba equivalent,
    biofilm_analysis.py:1229).

Everything — check heads, distance GEMMs, top-k, vote scatter — runs in one
jitted program per (batch shape, model shape).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
import optax

from hiprfish_tpu.config import ChannelLayout, ClassifierConfig
from hiprfish_tpu.models import metrics


# ---------------------------------------------------------------------------
# Check-bit heads
# ---------------------------------------------------------------------------


def _init_mlp(key, d_in: int, hidden: int):
    k1, k2 = jax.random.split(key)
    return {
        "w1": jax.random.normal(k1, (d_in, hidden), jnp.float32)
        * jnp.sqrt(2.0 / d_in),
        "b1": jnp.zeros((hidden,), jnp.float32),
        "w2": jax.random.normal(k2, (hidden, 1), jnp.float32)
        * jnp.sqrt(1.0 / hidden),
        "b2": jnp.zeros((1,), jnp.float32),
    }


def _mlp_logit(params, x):
    h = jax.nn.relu(x @ params["w1"] + params["b1"])
    return (h @ params["w2"] + params["b2"])[:, 0]


@functools.partial(jax.jit, static_argnums=(4, 5))
def _train_check_head(key, x, y, init_params, steps: int, lr: float):
    """Binary-cross-entropy training of one check head with Adam.

    Minibatches are contiguous dynamic slices of a once-shuffled copy of the
    data instead of a per-step random-index gather from the full training
    matrix inside the scan (6 heads x 300 steps x 4096 rows from
    (204600, 32) for the 10-bit build): one up-front permutation plus
    dynamic_slice is the same SGD without the gathers."""
    tx = optax.adam(lr)
    opt_state = tx.init(init_params)
    n = x.shape[0]
    bs = min(4096, n)
    perm = jax.random.permutation(key, n)
    xs = jnp.take(x, perm, axis=0)
    ys = jnp.take(y, perm, axis=0)

    def loss_fn(p, xb, yb):
        logit = _mlp_logit(p, xb)
        return jnp.mean(
            optax.sigmoid_binary_cross_entropy(logit, yb.astype(jnp.float32))
        )

    def step(carry, i):
        p, s = carry
        start = (i * bs) % jnp.maximum(n - bs + 1, 1)
        xb = jax.lax.dynamic_slice_in_dim(xs, start, bs)
        yb = jax.lax.dynamic_slice_in_dim(ys, start, bs)
        g = jax.grad(loss_fn)(p, xb, yb)
        updates, s = tx.update(g, s, p)
        return (optax.apply_updates(p, updates), s), None

    (params, _), _ = jax.lax.scan(
        step, (init_params, opt_state), jnp.arange(steps)
    )
    return params


_train_check_heads_batched = jax.jit(
    jax.vmap(_train_check_head, in_axes=(0, 0, 0, 0, None, None)),
    static_argnums=(4, 5),
)


# ---------------------------------------------------------------------------
# Classifier model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpectralClassifier:
    """Trained spectral barcode classifier artifact.

    Fields mirror the reference's 4-pickle artifact set (umap transform +
    embedding SVC + check SVC list + optional scaler,
    classify_spectra.py:56-59) in one object.
    """

    layout_name: str
    n_channels: int
    blocks: Tuple[Tuple[int, int], ...]        # metric blocks (may incl. derivative)
    check_slice: Tuple[int, int]
    codebook: Tuple[str, ...]                  # class index -> barcode string
    train_features: np.ndarray                 # (N, D) stored reference matrix
    train_labels: np.ndarray                   # (N,) int32 class indices
    check_params: Tuple[dict, ...]             # per-block MLP heads
    check_blocks: Tuple[Tuple[int, int], ...]  # input slices of the heads
    scaler_mean: Optional[np.ndarray] = None   # StandardScaler equivalent
    scaler_scale: Optional[np.ndarray] = None
    n_neighbors: int = 25
    temperature: float = 30.0
    violet_derivative: bool = False
    full_derivative: bool = False   # np.diff over ALL channels appended

    # -- check bits --------------------------------------------------------

    def scale(self, spectra: jax.Array) -> jax.Array:
        if self.scaler_mean is None:
            return spectra
        return (spectra - jnp.asarray(self.scaler_mean)) / jnp.asarray(
            self.scaler_scale
        )

    def predict_checks(self, spectra: jax.Array) -> jax.Array:
        """(N, n_checks) hard check-bit predictions from the block heads.
        ``spectra`` are the raw normalized channel features (pre-scaler).
        Head inputs are zero-padded to a common width so all heads share one
        compiled program."""
        scaled = self.scale(spectra[:, : self.n_channels])
        wmax = self.check_params[0]["w1"].shape[0]
        cols = []
        for params, (lo, hi) in zip(self.check_params, self.check_blocks):
            x = scaled[:, lo:hi] if hi <= self.n_channels else spectra[:, lo:hi]
            x = jnp.pad(x, ((0, 0), (0, wmax - (hi - lo))))
            cols.append((_mlp_logit(params, x) > 0).astype(jnp.float32))
        return jnp.stack(cols, axis=1)

    # -- barcode prediction --------------------------------------------------

    def build_features(self, avgint_norm: jax.Array) -> jax.Array:
        """Assemble the full metric feature vector from normalized spectra:
        [channels, (violet derivative), check bits] — the reference's feature
        build (image_classification.py:47-54 / classify_spectra.py:28-33)."""
        x = avgint_norm[:, : self.n_channels]
        feats = [x]
        if self.violet_derivative:
            lo, hi = self.blocks[0]
            feats.append(jnp.diff(x[:, lo:hi], axis=1))
        elif self.full_derivative:
            # "differentiated" variants: derivative across the whole spectrum
            # (train_reference.py:126-147, :2117-2146)
            feats.append(jnp.diff(x, axis=1))
        base = jnp.concatenate(feats, axis=1)
        checks = self.predict_checks(base)
        return jnp.concatenate([base, checks], axis=1)

    def predict_with_proba(self, features: jax.Array):
        """(codes, max_prob, probs) for fully-built feature vectors."""
        return _knn_predict(
            features,
            jnp.asarray(self.train_features),
            jnp.asarray(self.train_labels),
            len(self.codebook),
            self.blocks,
            self.check_slice,
            self.n_neighbors,
            self.temperature,
        )

    def classify(self, avgint_norm: jax.Array):
        """End-to-end: normalized spectra -> (barcode strings, max_prob,
        probs, features)."""
        features = self.build_features(avgint_norm)
        pred, max_prob, probs = self.predict_with_proba(features)
        codes = [self.codebook[int(i)] for i in np.asarray(pred)]
        return codes, np.asarray(max_prob), np.asarray(probs), np.asarray(features)


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def _knn_predict(
    q: jax.Array,
    train: jax.Array,
    labels: jax.Array,
    n_classes: int,
    blocks,
    check_slice,
    k: int,
    temperature: float,
):
    d = metrics.block_cosine_distance_matrix(q, train, blocks, check_slice)
    # exact k-NN selection: on the GPU approx_max_k lowers to the same
    # sort-based top-k and was no faster (tools/kernel_bench.py)
    k = min(k, train.shape[0] - 1) if train.shape[0] > 1 else 1
    neg_d, idx = jax.lax.top_k(-d, k)
    nb_labels = labels[idx]                            # (N, k)
    w = jax.nn.softmax(neg_d * temperature, axis=1)    # exp(-d*T) normalized
    n = q.shape[0]
    scores = jnp.zeros((n, n_classes), jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], nb_labels.shape)
    scores = scores.at[rows, nb_labels].add(w)
    pred = jnp.argmax(scores, axis=1)
    max_prob = jnp.max(scores, axis=1)
    return pred, max_prob, scores


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train_classifier(
    key,
    layout: ChannelLayout,
    spectra: np.ndarray,          # (N, C[+deriv]) simulated training spectra
    code_strings: Sequence[str],  # (N,) barcode string per row
    check_bits: np.ndarray,       # (N, n_checks) ground-truth check bits
    cfg: ClassifierConfig = ClassifierConfig(),
    scaler: bool = False,
    violet_derivative: bool = False,
    full_derivative: bool = False,
    check_spectra: np.ndarray | None = None,   # incl. negatives (defaults to spectra)
    check_bits_full: np.ndarray | None = None,
    knn_store_per_class: int | None = None,
    knn_prototypes_per_class: int | None | str = "auto",
) -> SpectralClassifier:
    """Fit the classifier: check heads on (optionally scaled) block slices,
    and the kNN reference matrix = [spectra, check bits] under the gated
    metric — the training recipe of train_reference.py:2034-2044 with the
    SVCs replaced by MLP check heads.

    The stored kNN matrix is thinned one of two ways: prototype averaging
    (``knn_prototypes_per_class``, the default — 8 noise-averaged
    prototypes per class) or raw-row subsetting (``knn_store_per_class``,
    the reference-faithful mechanism). Passing ``knn_store_per_class``
    alone switches to raw rows; an explicit integer
    ``knn_prototypes_per_class`` always wins."""
    spectra = np.asarray(spectra, np.float32)
    check_bits = np.asarray(check_bits, np.float32)
    if check_spectra is None:
        check_spectra = spectra
        check_bits_full = check_bits
    check_spectra = np.asarray(check_spectra, np.float32)
    check_bits_full = np.asarray(check_bits_full, np.float32)

    blocks, check_slice = metrics.metric_for_layout(layout, violet_derivative)
    n_channels = layout.n_channels
    if full_derivative:
        # the appended full-spectrum derivative is one extra ungated block
        blocks = tuple(blocks) + ((n_channels, 2 * n_channels - 1),)
        check_slice = (2 * n_channels - 1, 2 * n_channels - 1
                       + (check_slice[1] - check_slice[0]))

    scaler_mean = scaler_scale = None
    scaled = check_spectra[:, :n_channels]
    if scaler:
        scaler_mean = scaled.mean(axis=0)
        scaler_scale = scaled.std(axis=0) + 1e-12
        scaled = (scaled - scaler_mean) / scaler_scale

    # Check heads: one per metric block; derivative blocks (beyond the raw
    # channels) read the unscaled derivative features. Inputs are zero-padded
    # to a common width so all heads train as ONE vmapped program (a single
    # compile + a single batched Adam scan).
    n_heads = min(len(blocks), check_bits_full.shape[1])
    head_blocks = list(blocks[:n_heads])
    wmax = max(hi - lo for lo, hi in head_blocks)
    xs, ys, inits = [], [], []
    keys = jax.random.split(key, n_heads + 1)
    for b, (lo, hi) in enumerate(head_blocks):
        x = scaled[:, lo:hi] if hi <= n_channels else check_spectra[:, lo:hi]
        xs.append(np.pad(x, ((0, 0), (0, wmax - (hi - lo)))))
        ys.append(check_bits_full[:, b])
        inits.append(_init_mlp(keys[b], wmax, cfg.check_hidden))
    stacked_inits = jax.tree.map(lambda *a: jnp.stack(a), *inits)
    params_all = _train_check_heads_batched(
        jax.random.split(keys[-1], n_heads),
        jnp.asarray(np.stack(xs)),
        jnp.asarray(np.stack(ys)),
        stacked_inits,
        cfg.check_train_steps,
        cfg.check_lr,
    )
    params_all = jax.device_get(params_all)
    check_params = [
        {k: params_all[k][b] for k in params_all} for b in range(n_heads)
    ]
    check_blocks = head_blocks

    # kNN reference matrix (positives only, like the UMAP fit which excludes
    # the negative class, train_reference.py:2037).
    codebook = sorted(set(code_strings))
    code_to_idx = {c: i for i, c in enumerate(codebook)}
    labels = np.array([code_to_idx[c] for c in code_strings], np.int32)

    n_check_cols = check_slice[1] - check_slice[0]
    feats = np.concatenate([spectra, check_bits[:, :n_check_cols]],
                           axis=1).astype(np.float32)
    if knn_prototypes_per_class == "auto":
        # Default thinning is prototype averaging — but an explicit
        # knn_store_per_class request must not be silently overridden.
        knn_prototypes_per_class = \
            None if knn_store_per_class is not None else 8
    if knn_prototypes_per_class is not None:
        # Prototype averaging: store p noise-averaged prototypes per class
        # instead of raw simulated rows. Per-row simulation noise is what
        # makes one-bit-off classes win ties (measured on the 10-bit bench:
        # every error was a clean spectrum outranked by a noisy neighbor of
        # the code with bit 3 dropped — d_true-d_pred ~ 0.003, the noise
        # scale); averaging g=spc/p rows shrinks prototype noise by sqrt(g)
        # while keeping p-modal within-class structure (FRET/reabsorption
        # variants of train_reference.py populate multiple modes). Also
        # cuts the kNN GEMM ~spc/p-fold.
        order = np.argsort(labels, kind="stable")
        feats_s, labels_s = feats[order], labels[order]
        # group boundaries via one reduceat pass (a per-class boolean-mask
        # loop rescans the full matrix 1023x — measured 13 min on the
        # 204600x132 10-bit build)
        _, starts = np.unique(labels_s, return_index=True)
        ends = np.append(starts[1:], len(labels_s))
        group_starts, proto_labels = [], []
        for ci, (st, en) in enumerate(zip(starts, ends)):
            p = min(knn_prototypes_per_class, en - st)
            if p == 0:
                continue
            bounds = st + np.linspace(0, en - st, p + 1)[:-1].astype(int)
            group_starts.append(np.unique(bounds))
            proto_labels.extend([int(labels_s[st])] * len(group_starts[-1]))
        group_starts = np.concatenate(group_starts)
        sums = np.add.reduceat(feats_s.astype(np.float64), group_starts,
                               axis=0)
        sizes = np.diff(np.append(group_starts, len(labels_s)))
        feats = (sums / sizes[:, None]).astype(np.float32)
        labels = np.asarray(proto_labels, np.int32)
        # prototype check-bit columns must stay crisp 0/1 (they gate the
        # metric); within a class they are constant, so the mean is exact —
        # round defensively for float drift
        feats[:, spectra.shape[1]:] = np.round(feats[:, spectra.shape[1]:])
    elif knn_store_per_class is not None:
        keep = []
        for ci in range(len(codebook)):
            rows = np.where(labels == ci)[0][:knn_store_per_class]
            keep.append(rows)
        keep = np.concatenate(keep)
        feats = feats[keep]
        labels = labels[keep]

    return SpectralClassifier(
        layout_name=layout.name,
        n_channels=n_channels,
        blocks=blocks,
        check_slice=check_slice,
        codebook=tuple(codebook),
        train_features=feats,
        train_labels=labels,
        check_params=tuple(check_params),
        check_blocks=tuple(check_blocks),
        scaler_mean=scaler_mean,
        scaler_scale=scaler_scale,
        n_neighbors=cfg.n_neighbors,
        temperature=cfg.knn_temperature,
        violet_derivative=violet_derivative,
        full_derivative=full_derivative,
    )
