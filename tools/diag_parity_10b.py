"""Diagnose the ecoli_10b end-to-end parity disagreements, per cell.

Round-3 parity (PARITY_r03.json) left 10/2167 ecoli cells where the
system-stack barcode (twin on system-measured spectra) disagrees with the
oracle's end-to-end call, while same-spectra agreement is 100% — so every
disagreement traces to a segmentation/measurement difference. This tool
re-runs the ecoli_10b family sweep and, for EVERY disagreeing matched
pair, logs: scene, IoU, spectrum cosine, areas, planted truth on both
sides, both calls, and both sides' kNN vote margins — enough to localize
each flip to boundary pixels vs vote fragility.

Usage: JAX_PLATFORMS=cpu python tools/diag_parity_10b.py [out.json]
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

from hiprfish_tpu.config import TEN_BIT  # noqa: E402
from hiprfish_tpu.models import train as mtrain  # noqa: E402
from hiprfish_tpu.utils import synthetic  # noqa: E402

from ref_oracle import classify as rc  # noqa: E402
from ref_oracle import harness  # noqa: E402

import make_parity as mp  # noqa: E402


def twin_votes(twin, x_norm: np.ndarray, k: int = 25):
    """kNN calls + vote histogram over the twin's training matrix."""
    import jax
    import jax.numpy as jnp

    from hiprfish_tpu.models import metrics

    x = np.asarray(x_norm, np.float32)
    if twin.violet:
        x = np.concatenate([x, np.diff(x[:, :32], axis=1)], axis=1)
    checks = np.column_stack([
        np.asarray(s.predict(jnp.asarray(x[:, lo:hi])))
        for s, (lo, hi) in zip(twin.svcs, twin.check_blocks)])
    feats = jnp.asarray(
        np.concatenate([x, checks], axis=1).astype(np.float32))
    gates = tuple(b if twin.check_slice[0] + b < twin.check_slice[1]
                  else None for b in range(len(twin.blocks)))
    d = metrics._ref_gated_cosine_matrix(
        feats, twin.train, twin.blocks, twin.check_slice, gates,
        twin.scale, "one")
    _, idx = jax.lax.top_k(-d, min(k, d.shape[1]))
    idx = np.asarray(idx)
    calls, votes, margins = [], [], []
    for i in range(idx.shape[0]):
        codes, counts = np.unique(twin.codes[idx[i]], return_counts=True)
        order = np.argsort(-counts)
        calls.append(str(codes[order[0]]))
        votes.append({str(codes[j]): int(counts[j]) for j in order[:4]})
        margins.append(int(counts[order[0]] -
                           (counts[order[1]] if len(order) > 1 else 0)))
    return np.asarray(calls), votes, margins, checks


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "DIAG_PARITY_10B.json"
    t0 = time.time()

    tmp10 = tempfile.mkdtemp()
    encs_ref10 = mp.CODES_10B + [100, 200, 300, 400, 511, 767, 895, 959,
                                 991, 1007, 3, 7, 15, 31]
    synthetic.write_reference_folder(TEN_BIT, tmp10, encs_ref10,
                                     cells_per_code=40, seed=7)
    ref10 = rc.train_ref_10b(tmp10, spc=60, seed=1)
    sys10 = mtrain.train_excitation_adjusted_violet_derivative(
        tmp10, spc=60, seed=1, save=False)
    print(f"# classifiers built ({time.time()-t0:.0f}s)", file=sys.stderr,
          flush=True)

    codes = [mp.CODES_10B[i % len(mp.CODES_10B)]
             for i in range(mp.GRID * mp.GRID)]
    shifts = [(0, 0), (2, -1), (0, 3), (-2, 0), (1, 1)]
    twin = harness.SysOracleTwin(ref10)
    disagreements = []
    totals = {"n": 0, "agree": 0}
    for i in range(mp.N_FOVS):
        fov = mp.fov_scene(TEN_BIT, codes, i, shifts, (9.0, 14.0),
                           spacing=31.0)
        m, bundle = harness.segmentation_parity(fov, "ecoli",
                                                max_cells=mp.MAX_CELLS)
        c = harness.classification_parity(bundle, fov, codes, ref10, sys10,
                                          twin=twin)
        totals["n"] += c["e2e_n"]
        totals["agree"] += c["e2e_n_agree"]
        print(f"[fov {i}] matched {m['matched']}/{m['n_cells_ref']}, "
              f"e2e {c['e2e_n_agree']}/{c['e2e_n']} "
              f"({time.time()-t0:.0f}s)", file=sys.stderr, flush=True)
        if c["e2e_n_agree"] == c["e2e_n"]:
            continue

        norm_ref, norm_sys = bundle["norm_ref"], bundle["norm_sys"]
        calls_ref = np.asarray(
            [str(x).split("_")[0] for x in ref10.predict(norm_ref)])
        calls_twin_sys, votes_sys, margins_sys, _ = twin_votes(twin, norm_sys)
        calls_twin_ref, votes_ref, margins_ref, _ = twin_votes(twin, norm_ref)
        truth_ref = harness.truth_code_per_label(
            bundle["seg_ref"], fov["truth_labels"], codes)
        truth_sys = harness.truth_code_per_label(
            bundle["seg_sys"], fov["truth_labels"], codes)
        area_ref = np.bincount(bundle["seg_ref"].ravel())
        area_sys = np.bincount(bundle["seg_sys"].ravel())
        for a, b, iou in bundle["pairs"]:
            ra = bundle["ref_row"][a]
            if calls_ref[ra] == str(calls_twin_sys[b - 1]).split("_")[0]:
                continue
            u, v = norm_ref[ra], norm_sys[b - 1]
            cos = float(u @ v / (np.linalg.norm(u) * np.linalg.norm(v)
                                 + 1e-30))
            disagreements.append({
                "fov": i,
                "scene": ("nominal" if i < 3
                          else "high_noise" if i == 3 else "misregistered"),
                "label_ref": int(a), "label_sys": int(b),
                "iou": round(float(iou), 4),
                "spectrum_cos": round(cos, 6),
                "area_ref": int(area_ref[a]), "area_sys": int(area_sys[b]),
                "truth": format(truth_ref.get(int(a), -1), "010b"),
                "truth_sys_side": format(truth_sys.get(int(b), -1), "010b"),
                "call_oracle": str(calls_ref[ra]),
                "call_twin_on_sys_spectrum": str(calls_twin_sys[b - 1]),
                "call_twin_on_ref_spectrum": str(calls_twin_ref[ra]),
                "votes_on_sys_spectrum": votes_sys[b - 1],
                "votes_on_ref_spectrum": votes_ref[ra],
                "margin_on_sys_spectrum": margins_sys[b - 1],
                "margin_on_ref_spectrum": margins_ref[ra],
            })

    out = {"e2e_total": totals,
           "rate": totals["agree"] / max(totals["n"], 1),
           "n_disagreements": len(disagreements),
           "disagreements": disagreements,
           "runtime_s": round(time.time() - t0, 1)}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("rate", "n_disagreements",
                                          "runtime_s")}))
    print(f"wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
