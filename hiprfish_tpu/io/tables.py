"""Experiment tables and pipeline configuration files.

Keeps the reference's interfaces: the Snakemake JSON config
(hiprfish_config_imaging.json keys __default__.SCRIPTS_PATH / DATA_DIR /
PROBE_DESIGN_DIR, images.image_list_table / image_type) and the experiment
CSV tables (examples/images_table_*.csv with columns SAMPLE, IMAGES,
CALIBRATION, CALIBRATION_FILENAME, REFERENCE_FOLDER[, SPC,
INPUT_TAB_FILENAME, REFERENCE, DIMENSION, PROBEDESIGN]) so existing
experiment definitions run unchanged (ecoli/Snakefile:50-57).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    import pandas as pd


@dataclasses.dataclass
class WorkflowConfig:
    scripts_path: str
    data_dir: str
    image_list_table: str
    image_type: str  # 'R' reference | 'M' mix
    probe_design_dir: Optional[str] = None

    @classmethod
    def from_json(cls, path: str) -> "WorkflowConfig":
        with open(path) as f:
            cfg = json.load(f)
        default = cfg.get("__default__", {})
        images = cfg.get("images", {})
        return cls(
            scripts_path=default.get("SCRIPTS_PATH", ""),
            data_dir=default.get("DATA_DIR", ""),
            image_list_table=images.get("image_list_table", ""),
            image_type=images.get("image_type", "R"),
            probe_design_dir=default.get("PROBE_DESIGN_DIR"),
        )


def read_image_table(path: str) -> "pd.DataFrame":
    import pandas as pd

    return pd.read_csv(path)


def channel_image_filenames(data_dir: str, folder: str, sample: str, lasers) -> list:
    """Per-laser CZI paths, '{data_dir}/{folder}/{sample}_{laser}.czi'
    (ecoli/Snakefile:33-36)."""
    return [
        os.path.join(data_dir, folder, "{}_{}.czi".format(sample, exc))
        for exc in lasers
    ]


def parse_encoding(image_name: str) -> int:
    """Extract the barcode id from 'enc_<n>' in a sample name
    (collect_measurement_results.py:30)."""
    m = re.search(r"enc_([0-9]+)", image_name)
    if m is None:
        raise ValueError(f"no enc_<n> tag in {image_name!r}")
    return int(m.group(1))


def parse_fov(image_name: str) -> int:
    m = re.search(r"fov_([0-9]+)", image_name)
    if m is None:
        raise ValueError(f"no fov_<n> tag in {image_name!r}")
    return int(m.group(1))


def sample_from_image_name(image_name: str) -> str:
    """Strip the '_<laser>.czi' suffix (spectral_image_measurement.py:143)."""
    return re.sub(r"_[0-9]*\.(czi|npy|tif|tiff)$", "", image_name)


def reference_clf_path(data_dir: str, ref_folder: str, spc) -> str:
    """The ecoli classifier filename convention (ecoli/Snakefile:44-48)."""
    return os.path.join(
        data_dir,
        str(ref_folder),
        "reference_simulate_{}_excitation_adjusted_normalized_violet_derivative_"
        "umap_transform.pkl".format(spc),
    )


def _row_get(row, key, default=None):
    """Column lookup on a pandas row / Series / dict with a default for
    missing columns (tables from the ecoli pipeline lack the REFERENCE_*
    dispatch columns entirely)."""
    try:
        val = row[key]
    except (KeyError, IndexError):
        return default
    import pandas as pd

    if pd.isna(val):
        return default
    return val


def reference_clf_path_from_row(data_dir: str, row) -> str:
    """Full classifier-filename convention tree of the reference
    (hiprfish-image-analysis-reference/Snakefile:47-71): dispatch on
    REFERENCE_TYPE 'A' / REFERENCE_NORMALIZATION / REFERENCE_SCOPE 'Select'
    (mix id parsed from INPUT_TAB_FILENAME) / REFERENCE_UMAP.

    ``row`` is one experiment-table row (pandas Series or dict). Missing
    columns default to the ecoli convention (normalized, umap, full scope).
    """
    ref_folder = _row_get(row, "REFERENCE_FOLDER", "")
    spc = _row_get(row, "SPC", 2000)
    ref_type = _row_get(row, "REFERENCE_TYPE", "S")
    ref_norm = _row_get(row, "REFERENCE_NORMALIZATION", "T")
    ref_scope = _row_get(row, "REFERENCE_SCOPE", "All")
    ref_umap = _row_get(row, "REFERENCE_UMAP", "T")

    def path(name: str) -> str:
        return os.path.join(data_dir, str(ref_folder), name)

    mix_id = None
    if ref_scope == "Select":
        tab = str(_row_get(row, "INPUT_TAB_FILENAME", ""))
        m = re.search(r"mix_([0-9]+)", tab)
        if m is None:
            raise ValueError(
                "REFERENCE_SCOPE='Select' requires a 'mix_<n>' tag in "
                f"INPUT_TAB_FILENAME (got {tab!r}; reference/Snakefile:55)")
        mix_id = int(m.group(1))

    if ref_type == "A":
        return path("reference_all.pkl")
    if ref_norm == "T":
        if ref_scope == "Select":
            return path(
                "reference_simulate_select_mix_{}_{}_normalized_"
                "umap_transform.pkl".format(mix_id, spc))
        if ref_umap == "T":
            return path(
                "reference_simulate_{}_excitation_adjusted_normalized_"
                "violet_derivative_umap_transform.pkl".format(spc))
        return path(
            "reference_simulate_{}_normalized_excitation_adjusted.pkl".format(spc))
    if ref_scope == "Select":
        return path("reference_simulate_select_mix_{}_{}.pkl".format(mix_id, spc))
    return path("reference_simulate_{}.pkl".format(spc))


def read_probe_design(path: str) -> "pd.DataFrame":
    """Probe-design CSV with string barcode codes (biofilm_analysis.py:1428)."""
    import pandas as pd

    return pd.read_csv(path, dtype={"code": str})
