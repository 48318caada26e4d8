"""L4: per-cell spectral classification.

Mirrors the reference's two classification front-ends:

* ``classify_ecoli``: 10-bit path — renormalize measured spectra, build the
  132-d feature vector (95 channels + 31 violet-derivative + 6 check bits),
  classify, write {sample}_cell_ids.txt / _avgint_ids.csv / identification
  image (hiprfish_imaging_image_classification.py:38-72).

* ``classify_spectra_7b``: 7-bit path — 63 channels + 4 check bits with the
  trained scaler, writes {sample}_cell_information.csv with regionprops
  columns (hiprfish_imaging_classify_spectra.py:23-49).

The classifier itself (check heads + gated-metric kNN) is the artifact
from models/classifier.py.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import jax.numpy as jnp

from hiprfish_tpu.io import outputs
from hiprfish_tpu.models.classifier import SpectralClassifier
from hiprfish_tpu.ops import regionprops as rp


def paint_identification(segmentation: np.ndarray, codes, n_cells: int):
    """Barcode-valued identification image: cell with sequential label i+1
    painted with int(code, 2). Makes the reference's row-index==label
    contract explicit (image_classification.py:65-70, SURVEY.md §2.4)."""
    lut = np.zeros(n_cells + 1, np.int64)
    for i, c in enumerate(codes):
        lut[i + 1] = int(str(c).split("_")[0], 2)
    seg = np.asarray(segmentation)
    return lut[np.clip(seg, 0, n_cells)]


def classify_ecoli(avgint_filename: str, clf: SpectralClassifier,
                   save_png: bool = True):
    """Classify one measured FOV's spectra (10-bit ecoli path).

    Reads {sample}_avgint.csv + {sample}_seg.npy, writes _cell_ids.txt,
    _avgint_ids.csv, _identification.png. Returns the barcode strings.
    """
    sample = avgint_filename[: -len("_avgint.csv")]
    avgint = pd.read_csv(avgint_filename, header=None).values
    segmentation = np.load(sample + "_seg.npy")
    avgint_norm = avgint / np.maximum(avgint.max(axis=1, keepdims=True), 1e-12)

    codes, max_prob, probs, feats = clf.classify(jnp.asarray(avgint_norm))

    outputs.save_cell_ids(sample + "_cell_ids.txt", codes)
    ident = pd.DataFrame(
        np.concatenate([np.asarray(feats), np.array(codes)[:, None]], axis=1)
    )
    ident[ident.shape[1]] = sample
    ident[ident.shape[1]] = np.arange(1, len(codes) + 1)  # sequential labels
    ident.to_csv(sample + "_avgint_ids.csv", header=None, index=None)

    if save_png:
        image_identification = paint_identification(
            segmentation, codes, len(codes))
        outputs.save_identification_png(image_identification, sample)
    return codes


def classify_ecoli_legacy(avgint_filename: str, transform_path: str,
                          save_png: bool = True):
    """Classify one FOV with the reference's own 3-pickle UMAP artifact
    stack, loaded without umap-learn and scored on device
    (image_classification.py:38-72 column-for-column: 95 channels + 31
    violet-derivative + 6 check-SVC bits -> UMAP embed -> embedded SVC)."""
    from hiprfish_tpu.models import umap_infer

    sample = avgint_filename[: -len("_avgint.csv")]
    avgint = pd.read_csv(avgint_filename, header=None).values
    segmentation = np.load(sample + "_seg.npy")
    avgint_norm = avgint / np.maximum(avgint.max(axis=1, keepdims=True),
                                      1e-12)
    n = avgint_norm.shape[0]
    feats = np.concatenate(
        [avgint_norm, np.zeros((n, 37), np.float32)], axis=1)
    feats[:, 95:126] = np.diff(feats[:, 0:32], axis=1)

    stack = umap_infer.load_legacy_umap_stack(transform_path)
    codes = np.asarray(stack.predict(feats)).astype(str)

    outputs.save_cell_ids(sample + "_cell_ids.txt", codes)
    ident = pd.DataFrame(
        np.concatenate([feats, codes[:, None]], axis=1))
    ident[ident.shape[1]] = sample
    ident[ident.shape[1]] = np.arange(1, n + 1)
    ident.to_csv(sample + "_avgint_ids.csv", header=None, index=None)
    if save_png:
        image_identification = paint_identification(segmentation, codes, n)
        outputs.save_identification_png(image_identification, sample)
    return codes


def classify_spectra_7b_legacy(input_spectra: str, transform_path: str):
    """Classify one FOV's 7-bit spectra with the reference's own 4-pickle
    stack (umap transform + scaler + embedded SVC + check SVCs), writing
    the same cell_information table (classify_spectra.py:23-49)."""
    from hiprfish_tpu.models import umap_infer

    sample = input_spectra[: -len("_avgint_norm.csv")]
    avgint = pd.read_csv(input_spectra).values
    segmentation = np.load(sample + "_seg.npy")
    avgint_norm = avgint / np.maximum(avgint.max(axis=1, keepdims=True),
                                      1e-12)
    n = avgint_norm.shape[0]
    feats = np.concatenate(
        [avgint_norm, np.zeros((n, 4), np.float32)], axis=1)
    stack = umap_infer.load_legacy_umap_stack_7b(transform_path)
    codes, feats = stack.predict(feats, return_checks=True)
    codes = np.asarray(codes).astype(str)

    max_cells = 1 << max(4, int(np.ceil(np.log2(n + 2))))
    props = {
        k: np.asarray(v)[1 : n + 1]
        for k, v in rp.shape_props_2d(jnp.asarray(segmentation),
                                      max_cells).items()
    }
    cell_info = pd.DataFrame(
        np.concatenate([feats, codes[:, None]], axis=1))
    col = cell_info.shape[1]
    cell_info[col] = sample
    cell_info[col + 1] = np.arange(1, n + 1)
    cell_info[col + 2] = props["centroid_r"]
    cell_info[col + 3] = props["centroid_c"]
    cell_info[col + 4] = props["major_axis_length"]
    cell_info[col + 5] = props["minor_axis_length"]
    cell_info[col + 6] = props["eccentricity"]
    cell_info[col + 7] = props["orientation"]
    cell_info[col + 8] = props["area"]
    cell_info.to_csv(sample + "_cell_information.csv", index=None,
                     header=None)
    return codes


def classify_spectra_7b(input_spectra: str, clf: SpectralClassifier,
                        save_png: bool = False):
    """Classify one FOV's 7-bit spectra and write the cell_information table
    (classify_spectra.py:23-49: 63 features + 4 check bits + barcode +
    sample + label + centroid/axes/eccentricity/orientation/area)."""
    sample = input_spectra[: -len("_avgint_norm.csv")]
    avgint = pd.read_csv(input_spectra).values
    segmentation = np.load(sample + "_seg.npy")
    avgint_norm = avgint / np.maximum(avgint.max(axis=1, keepdims=True), 1e-12)

    codes, max_prob, probs, feats = clf.classify(jnp.asarray(avgint_norm))

    n = len(codes)
    max_cells = 1 << max(4, int(np.ceil(np.log2(n + 2))))
    props = {
        k: np.asarray(v)[1 : n + 1]
        for k, v in rp.shape_props_2d(jnp.asarray(segmentation), max_cells).items()
    }
    cell_info = pd.DataFrame(
        np.concatenate([np.asarray(feats), np.array(codes)[:, None]], axis=1)
    )
    col = cell_info.shape[1]
    cell_info[col] = sample
    cell_info[col + 1] = np.arange(1, n + 1)
    cell_info[col + 2] = props["centroid_r"]
    cell_info[col + 3] = props["centroid_c"]
    cell_info[col + 4] = props["major_axis_length"]
    cell_info[col + 5] = props["minor_axis_length"]
    cell_info[col + 6] = props["eccentricity"]
    cell_info[col + 7] = props["orientation"]
    cell_info[col + 8] = props["area"]
    cell_info.to_csv(sample + "_cell_information.csv", index=None, header=None)

    if save_png:
        outputs.save_identification_png(
            paint_identification(segmentation, codes, n), sample)
    return codes
