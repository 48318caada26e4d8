"""Classifier artifact persistence + legacy joblib-pickle interop.

Native format: a single .npz bundling the stored reference matrix, check-head
weights, scaler, and JSON metadata — the one-file equivalent of the
reference's 4-pickle artifact set (umap_transform / svc / check_svc / scaler,
classify_spectra.py:56-59). Filenames keep the reference's naming convention
with .npz substituted for .pkl so the workflow driver's path logic carries
over (ecoli/Snakefile:44-48).

Legacy interop: ``load_reference_svc`` re-expresses a pickled sklearn RBF-SVC
as stored support vectors + coefficients evaluated with one JAX GEMM, so
reference-trained check SVCs can be scored on the device for parity testing
(requires sklearn only to unpickle).
"""

from __future__ import annotations

import json

import numpy as np

from hiprfish_tpu.models.classifier import SpectralClassifier


def save_classifier(path: str, clf: SpectralClassifier) -> None:
    arrays = {
        "train_features": clf.train_features,
        "train_labels": clf.train_labels,
    }
    if clf.scaler_mean is not None:
        arrays["scaler_mean"] = clf.scaler_mean
        arrays["scaler_scale"] = clf.scaler_scale
    for b, params in enumerate(clf.check_params):
        for k, v in params.items():
            arrays[f"check{b}/{k}"] = np.asarray(v)
    meta = {
        "layout_name": clf.layout_name,
        "n_channels": clf.n_channels,
        "blocks": [list(b) for b in clf.blocks],
        "check_slice": list(clf.check_slice),
        "codebook": list(clf.codebook),
        "check_blocks": [list(b) for b in clf.check_blocks],
        "n_neighbors": clf.n_neighbors,
        "temperature": clf.temperature,
        "violet_derivative": clf.violet_derivative,
        "full_derivative": clf.full_derivative,
        "n_check_heads": len(clf.check_params),
    }
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_classifier(path: str) -> SpectralClassifier:
    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["meta_json"]).decode())
    check_params = []
    for b in range(meta["n_check_heads"]):
        check_params.append(
            {k: z[f"check{b}/{k}"] for k in ("w1", "b1", "w2", "b2")}
        )
    return SpectralClassifier(
        layout_name=meta["layout_name"],
        n_channels=meta["n_channels"],
        blocks=tuple(tuple(b) for b in meta["blocks"]),
        check_slice=tuple(meta["check_slice"]),
        codebook=tuple(meta["codebook"]),
        train_features=z["train_features"],
        train_labels=z["train_labels"],
        check_params=tuple(check_params),
        check_blocks=tuple(tuple(b) for b in meta["check_blocks"]),
        scaler_mean=z["scaler_mean"] if "scaler_mean" in z else None,
        scaler_scale=z["scaler_scale"] if "scaler_scale" in z else None,
        n_neighbors=meta["n_neighbors"],
        temperature=meta["temperature"],
        violet_derivative=meta["violet_derivative"],
        full_derivative=meta.get("full_derivative", False),
    )


# ---------------------------------------------------------------------------
# Legacy sklearn interop (parity harness)
# ---------------------------------------------------------------------------


class JaxRbfSvc:
    """An sklearn RBF SVC re-expressed as JAX GEMMs for device scoring.

    decision(x) = sum_i dual_coef_i * exp(-gamma ||x - sv_i||^2) + b, with
    one-vs-one voting for multiclass — numerically identical to
    sklearn.svm.SVC.predict on the same support vectors.
    """

    def __init__(self, support_vectors, dual_coef, intercept, gamma,
                 classes, n_support, probA=None, probB=None):
        self.sv = np.asarray(support_vectors, np.float32)
        self.dual_coef = np.asarray(dual_coef, np.float32)
        self.intercept = np.asarray(intercept, np.float32)
        self.gamma = float(gamma)
        self.classes = np.asarray(classes)
        self.n_support = np.asarray(n_support)
        self.probA = None if probA is None or len(probA) == 0 \
            else np.asarray(probA, np.float64)
        self.probB = None if probB is None or len(probB) == 0 \
            else np.asarray(probB, np.float64)

    @classmethod
    def from_sklearn(cls, svc):
        gamma = svc._gamma if hasattr(svc, "_gamma") else svc.gamma
        return cls(
            svc.support_vectors_, svc.dual_coef_, svc.intercept_, gamma,
            svc.classes_, svc.n_support_,
            getattr(svc, "probA_", None), getattr(svc, "probB_", None),
        )

    def decision_function_ovo(self, x):
        import jax.numpy as jnp

        x = jnp.asarray(x, jnp.float32)
        sv = jnp.asarray(self.sv)
        x2 = jnp.sum(x * x, axis=1, keepdims=True)
        s2 = jnp.sum(sv * sv, axis=1)[None, :]
        d2 = x2 + s2 - 2.0 * jnp.dot(x, sv.T, preferred_element_type=jnp.float32)
        kern = jnp.exp(-self.gamma * jnp.maximum(d2, 0.0))
        n_classes = len(self.classes)
        starts = np.concatenate([[0], np.cumsum(self.n_support)])
        dec = []
        dual = jnp.asarray(self.dual_coef)
        p = 0
        for i in range(n_classes):
            for j in range(i + 1, n_classes):
                ki = kern[:, starts[i]:starts[i + 1]]
                kj = kern[:, starts[j]:starts[j + 1]]
                ci = dual[j - 1, starts[i]:starts[i + 1]]
                cj = dual[i, starts[j]:starts[j + 1]]
                dec.append(ki @ ci + kj @ cj + self.intercept[p])
                p += 1
        import jax.numpy as jnp2

        return jnp2.stack(dec, axis=1)

    def predict(self, x):
        import jax.numpy as jnp

        n_classes = len(self.classes)
        if n_classes == 2:
            d = self.decision_function_ovo(x)[:, 0]
            return self.classes[(d > 0).astype(int)]
        dec = np.asarray(self.decision_function_ovo(x))
        votes = np.zeros((dec.shape[0], n_classes), np.int32)
        p = 0
        for i in range(n_classes):
            for j in range(i + 1, n_classes):
                win = dec[:, p] > 0
                votes[win, i] += 1
                votes[~win, j] += 1
                p += 1
        return self.classes[np.argmax(votes, axis=1)]

    def predict_proba(self, x, n_iter: int = 100):
        """Class probabilities via sklearn's algorithm: per-pair Platt
        sigmoids (the pickled probA_/probB_ coefficients) coupled into
        multiclass probabilities with Wu-Lin-Weng pairwise coupling — the
        path the reference's biofilm measurement exercises
        (biofilm_analysis.py:1227 clf_umap.predict_proba). Requires the SVC
        to have been fit with probability=True."""
        if self.probA is None:
            raise ValueError("SVC was not fit with probability=True")
        dec = np.asarray(self.decision_function_ovo(x), np.float64)
        n = dec.shape[0]
        k = len(self.classes)
        # pairwise probabilities r[i,j] = P(class i | i or j)
        r = np.zeros((n, k, k))
        p = 0
        for i in range(k):
            for j in range(i + 1, k):
                val = dec[:, p] * self.probA[p] + self.probB[p]
                pij = 1.0 / (1.0 + np.exp(np.clip(val, -500, 500)))
                pij = np.clip(pij, 1e-7, 1 - 1e-7)
                r[:, i, j] = pij
                r[:, j, i] = 1.0 - pij
                p += 1
        # Wu-Lin-Weng method 2 fixed-point iteration (libsvm's
        # multiclass_probability, svm.cpp)
        prob = np.full((n, k), 1.0 / k)
        Q = np.zeros((n, k, k))
        for i in range(k):
            Q[:, i, i] = (r[:, :, i] ** 2).sum(axis=1) - r[:, i, i] ** 2
            for j in range(k):
                if j != i:
                    Q[:, i, j] = -r[:, j, i] * r[:, i, j]
        for _ in range(n_iter):
            Qp = np.einsum("nij,nj->ni", Q, prob)
            pQp = np.einsum("ni,ni->n", prob, Qp)
            if np.abs(Qp - pQp[:, None]).max() < 0.005 / k:
                break
            for t in range(k):
                diff = (-Qp[:, t] + pQp) / Q[:, t, t]
                prob[:, t] += diff
                pQp = ((pQp + diff * (diff * Q[:, t, t] + 2 * Qp[:, t]))
                       / (1 + diff) ** 2)
                Qp = (Qp + diff[:, None] * Q[:, t, :]) / (1 + diff)[:, None]
                prob /= (1 + diff)[:, None]
        return prob / prob.sum(axis=1, keepdims=True)


def load_reference_svc(path: str) -> JaxRbfSvc:
    """Load a reference joblib SVC pickle and wrap it for device scoring."""
    import joblib

    obj = joblib.load(path)
    if isinstance(obj, list):
        return [JaxRbfSvc.from_sklearn(s) for s in obj]
    return JaxRbfSvc.from_sklearn(obj)
