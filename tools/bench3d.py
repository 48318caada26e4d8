"""Full-scale 3D biofilm benchmark: the reference's flagship
memory-efficient volume (2020 x 2020 x 170 stitched from 8 microscope
tiles, hiprfish_imaging_biofilm_analysis.py:1064-1171) end-to-end on one
chip: tile stitching (chained phase-correlation + overlap blend) ->
xy-chunked fused 3D LP-CV enhancement -> 3D KMeans/morphology seeding ->
3D watershed -> sequential relabel -> streamed per-cell spectral
measurement (63 channels, z-slab segment_sum) -> 127-code kNN
classification -> accuracy vs the analytic planted truth.

All data is generated on device (utils/synthetic3d) — the spectral volume
would be ~175 GB and never materializes. Returns a metrics dict; run
standalone to print it.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from hiprfish_tpu.utils.platform import apply_platform_env

apply_platform_env()


def run(shape=(2020, 2020, 170), tile_grid=(2, 4), overlap=60,
        chunk_xy=128, z_chunk=2, max_cells=16384, verbose=True):
    """Run the volume end to end twice — a cold pass, then a pass with
    every program warm, reported as the headline with the cold pass
    beside it; returns a metrics dict."""
    import jax
    import jax.numpy as jnp

    # Cap the tile id-floods' scan-doubling distance at the fixture's max
    # cell extent (28 px xy / 22 px z < 32): the tail doubling steps up to
    # the 60-px margin are provably idle memory passes. Convergence is
    # fixpoint-checked, so a too-small cap can only add rounds, never
    # change the labels (ops/labeling._run_min_scan).
    os.environ.setdefault("HIPRFISH_3D_SCAN_CAP", "32")

    from hiprfish_tpu.config import SEVEN_BIT, ClassifierConfig, \
        SegmentationConfig
    from hiprfish_tpu.models import train as mtrain
    from hiprfish_tpu.models.classifier import train_classifier
    from hiprfish_tpu.pipeline import segment3d
    from hiprfish_tpu.utils import synthetic, synthetic3d as s3

    def log(msg):
        if verbose:
            print(f"# {msg}", file=sys.stderr)

    sync = jax.block_until_ready

    layout = SEVEN_BIT
    codes = list(range(1, 128))
    lut = np.stack([synthetic.barcode_spectrum(layout, c) for c in codes])
    spec = s3.VolumeSpec(shape=shape, seed=5,
                         spacing=(36, 36, min(52, shape[2])))
    n_cells_true = spec.n_cells
    log(f"volume {shape}, grid {spec.grid} = {n_cells_true} cells")

    # Classifier (same 127-code construction as bench.py's 2D headline).
    rng = np.random.RandomState(0)
    rows, code_strs = [], []
    for c in codes:
        sp = synthetic.barcode_spectrum(layout, c, None)
        r = rng.uniform(0.7, 1.3, (50, 1)) * sp[None, :] + \
            rng.randn(50, layout.n_channels) * 0.02
        rows.append(np.clip(r, 0, None))
        code_strs += [layout.code_str(c)] * 50
    spectra = np.concatenate(rows).astype(np.float32)
    spectra /= np.maximum(spectra.max(axis=1, keepdims=True), 1e-12)
    checks = mtrain.check_bits_for_codes(layout, code_strs)
    clf = train_classifier(jax.random.PRNGKey(0), layout, spectra, code_strs,
                           checks, ClassifierConfig(check_train_steps=300))
    code_str_to_idx = {c: i for i, c in enumerate(clf.codebook)}
    # lut row i is barcode i+1; classifier class for lut row i:
    lut_class = np.array([code_str_to_idx[layout.code_str(c)] for c in codes])

    timings = {}

    # Overlap the cold-process XLA compiles (tile program + measurement +
    # classifier) with fixture construction and the early pipeline stages
    # (see warmup_pipeline).
    import threading
    lut_dev = jnp.asarray(lut, jnp.float32)
    # rbg keys: the measure stream draws noise over the 175 GB-equivalent
    # spectral volume, and threefry's hash dominated that generator.
    # "rbg" is XLA's RngBitGenerator: same distribution, a different
    # realization (the exact-count + accuracy gates below hold either way).
    loader_key = jax.random.key(1, impl="rbg")

    def loader(z0, zc):
        # bf16 slabs: halves the generator write + measurement read of the
        # 175 GB-equivalent spectral stream; gated by the bench's own
        # exact-count + accuracy checks.
        return s3.channel_chunk_cm(spec, len(codes), z0, zc, lut_dev,
                                   loader_key, jnp.bfloat16)

    # One-dispatch fused measurement program (loader + scatter-add
    # accumulate under a single fori_loop)
    fused_measure = segment3d.make_fused_measure(
        loader, shape, z_chunk, layout.n_channels, max_cells)
    warm_join = segment3d.warmup_pipeline(
        shape, SegmentationConfig(), max_cells, z_chunk=z_chunk,
        n_channels=layout.n_channels, measure_runner=fused_measure)

    def warm_classify():
        time.sleep(30)       # classify is last; stay off the compile queue
        f = clf.build_features(jnp.zeros((max_cells, layout.n_channels),
                                         jnp.float32))
        sync(clf.predict_with_proba(f))

    def warm_stitch():
        # Stitch runs right after the fixture build; AOT-lower its
        # program now so only execution lands on the timed stage.
        gy_, gx_ = tile_grid
        ty_ = (shape[0] + (gy_ - 1) * overlap) // gy_
        tx_ = (shape[1] + (gx_ - 1) * overlap) // gx_
        t_spec = jax.ShapeDtypeStruct((ty_, tx_, shape[2]), jnp.float32)
        segment3d._stitch_device.lower(
            (t_spec,) * (gy_ * gx_), (t_spec,) * (gy_ * gx_), tile_grid,
            overlap, (shape[0], shape[1], shape[2]), 10, overlap).compile()

    warm_clf_t = threading.Thread(target=warm_classify, daemon=True)
    warm_clf_t.start()
    warm_stitch_t = threading.Thread(target=warm_stitch, daemon=True)
    warm_stitch_t.start()

    # ---- generate + cut tiles (untimed: fixture construction) ----
    def build_tiles():
        t0 = time.time()
        vol = s3.build_sum_volume(spec, len(codes), lut.sum(axis=1), seed=1,
                                  z_chunk=16)
        sync(vol)
        log(f"fixture volume built on device in {time.time()-t0:.1f}s")
        gy, gx = tile_grid
        ty = (shape[0] + (gy - 1) * overlap) // gy
        tx = (shape[1] + (gx - 1) * overlap) // gx
        step_y, step_x = ty - overlap, tx - overlap
        shift_rng = np.random.RandomState(3)
        tile_shifts = [tuple(shift_rng.randint(-3, 4, 3))
                       for _ in range(gy * gx)]
        tile_shifts[0] = (0, 0, 0)
        # A shifted microscope tile sees TRUE scene content at its edges,
        # so cut each tile's window (offset by its shift) from a padded
        # copy of the scene. The earlier jnp.roll fixture wrapped the
        # opposite edge's pixels in — garbage strips real acquisition
        # never produces, which seeded spurious cells in the stitched
        # overlaps (the +2% r2 over-detection: BENCH_3D_DIAG showed
        # uniform-in-x duplicates + thin sheet-shaped noise labels, both
        # stitch-seam shaped).
        S = 3
        volp = jnp.pad(vol, ((S, S), (S, S), (S, S)), mode="edge")
        # free the unpadded scene before cutting: vol + volp + 8 tiles was
        # an ~11 GB transient peak that, concurrent with cold-process
        # warmup compiles, cascaded into RESOURCE_EXHAUSTED (2026-08-18)
        sync(volp)
        del vol
        tiles = [
            jax.lax.dynamic_slice(
                volp,
                (i * step_y + S - tile_shifts[i * gx + j][0],
                 j * step_x + S - tile_shifts[i * gx + j][1],
                 S - tile_shifts[i * gx + j][2]),
                (ty, tx, shape[2]))
            for i in range(gy) for j in range(gx)
        ]
        sync(tiles[-1])
        return tiles

    tiles = build_tiles()

    # ---- stitch (timed) ----
    pad = 10
    warm_stitch_t.join()

    def run_stitch(tiles, timings):
        t0 = time.time()
        stitched = segment3d.stitch_tiles_device(
            tiles, tile_grid, overlap, (shape[0], shape[1], shape[2]),
            pad=pad)
        sync(stitched)
        timings["stitch_s"] = time.time() - t0
        log(f"stitch: {timings['stitch_s']:.1f}s")
        return stitched[pad:pad + shape[0], pad:pad + shape[1],
                        pad:pad + shape[2]]

    stitched = run_stitch(tiles, timings)
    del tiles

    # ---- segment (timed) ----
    cfg = SegmentationConfig()

    def run_segment(stitched_box, timings):
        t0 = time.time()
        # xzy labels: the fused measure consumes (Z, X, Y), so the
        # transpose below is a cheap major-dims permute instead of a
        # minor-dim shuffle
        seg_xzy, n_cells, enhanced = segment3d.segment_3d_tiled(
            stitched_box, cfg, max_cells, chunk_xy=chunk_xy,
            out_layout="xzy")
        sync(seg_xzy)
        timings["segment_s"] = time.time() - t0
        del enhanced  # tiled path returns None
        n_found = int(n_cells)
        log(f"segment: {timings['segment_s']:.1f}s, {n_found} cells "
            f"(true {n_cells_true})")
        return seg_xzy, n_found

    vol_box = [stitched]          # ownership transfer: the segmenter pops
    del stitched                  # it so the 2.8 GB input frees mid-pipeline
    seg_xzy, n_found = run_segment(vol_box, timings)

    # ---- measure (timed): 63-channel per-cell spectral sums ----
    def run_measure(seg_xzy, timings):
        t0 = time.time()
        # (X, Z, Y) -> (Z, X, Y): major-dims permute, minor Y fixed
        avg = sync(fused_measure(jnp.transpose(seg_xzy, (1, 0, 2))))
        timings["measure_s"] = time.time() - t0
        log(f"measure (fused one-dispatch): {timings['measure_s']:.1f}s")
        return avg

    avg = run_measure(seg_xzy, timings)

    # ---- classify (timed) ----
    def run_classify(avg, timings):
        t0 = time.time()
        norm = avg / jnp.maximum(jnp.max(avg, axis=1, keepdims=True),
                                 1e-12)
        pred_idx, _, _ = clf.predict_with_proba(clf.build_features(norm))
        sync(pred_idx)
        timings["classify_s"] = time.time() - t0
        log(f"classify: {timings['classify_s']:.1f}s")
        return pred_idx

    pred_idx = run_classify(avg, timings)
    warm_join()          # no-op by now; tidies the warmup threads
    warm_clf_t.join()

    # ---- steady-state pass (the headline, matching the 2D configs'
    # first-call-discarded methodology): the first pass pays whatever
    # compiles the warm-up threads had not finished; the second pass runs
    # with every program warm in THIS process and isolates pipeline
    # throughput. The first (cold) pass is reported alongside.
    cold = dict(timings)
    # free the cold pass's outputs first (the label volume is ~2.8 GB; the
    # steady pass reproduces identical content)
    del avg, seg_xzy
    tiles2 = build_tiles()
    stitched2 = run_stitch(tiles2, timings)
    del tiles2
    box2 = [stitched2]
    del stitched2
    seg_xzy, n_found = run_segment(box2, timings)
    avg = run_measure(seg_xzy, timings)
    pred_idx = run_classify(avg, timings)

    # ---- accuracy vs planted truth (untimed validation) ----
    # the diagnostics below slice z from an (X, Y, Z) label volume
    seg = jnp.transpose(seg_xzy, (0, 2, 1))
    del seg_xzy
    import functools

    @functools.partial(jax.jit, static_argnums=(3,))
    def overlap_chunk(acc, seg_full, z0, zc):
        # seg passed as an argument: closing over the 4 GB device array
        # would embed it in the program as a constant
        truth, code_idx, _ = s3.truth_chunk(spec, len(codes), z0, zc)
        seg_c = jax.lax.dynamic_slice_in_dim(seg_full, z0, zc, 2)
        flat = jnp.where(truth > 0, seg_c * len(codes) + code_idx,
                         0).reshape(-1)
        return acc + jnp.bincount(
            flat, length=max_cells * len(codes)).astype(jnp.int32)

    acc_counts = jnp.zeros((max_cells * len(codes),), jnp.int32)
    for z0 in range(0, shape[2], 32):
        zc = min(32, shape[2] - z0)
        acc_counts = overlap_chunk(acc_counts, seg, z0, zc)
    counts = np.asarray(acc_counts).reshape(max_cells, len(codes)).copy()
    counts[0] = 0
    majority_code_row = counts.argmax(axis=1)       # lut row index
    has_truth = counts.sum(axis=1) > 0
    truth_class = lut_class[majority_code_row]
    pred = np.asarray(pred_idx)
    labs = np.arange(1, min(n_found, max_cells - 1) + 1)
    valid = has_truth[labs]
    correct = (pred[labs][valid] == truth_class[labs][valid])
    accuracy = float(correct.mean()) if valid.any() else 0.0

    if os.environ.get("BENCH_3D_DIAG"):
        # Over-detection forensics: majority TRUTH CELL (not just code) per
        # found label -> duplicate counts, plus each label's axis-0 centroid
        # -> distance to the nearest tile boundary (240-px tiling of
        # segment_3d_tiled). Duplicates clustered at boundaries indict the
        # union-find merge; uniform duplicates indict seeding.
        n_truth = spec.n_cells + 1

        @functools.partial(jax.jit, static_argnums=(3,))
        def tid_chunk(acc, seg_full, z0, zc):
            truth, _, _ = s3.truth_chunk(spec, len(codes), z0, zc)
            seg_c = jax.lax.dynamic_slice_in_dim(seg_full, z0, zc, 2)
            flat = jnp.where(truth > 0, seg_c * n_truth + truth,
                             0).reshape(-1)
            return acc + jnp.bincount(
                flat, length=max_cells * n_truth).astype(jnp.int32)

        acc_t = jnp.zeros((max_cells * n_truth,), jnp.int32)
        for z0 in range(0, shape[2], 8):
            zc = min(8, shape[2] - z0)
            acc_t = tid_chunk(acc_t, seg, z0, zc)
        ct = np.asarray(acc_t).reshape(max_cells, n_truth).copy()
        ct[0] = 0
        ct[:, 0] = 0
        maj_truth = ct.argmax(axis=1)
        has_t = ct.sum(axis=1) > 0

        # Axis-0 centroid per label via x-chunked weighted bincounts —
        # label_stats(moments=True) on the full volume materializes a
        # [n_vox, 5] scatter buffer (22 GB, measured OOM).
        @functools.partial(jax.jit, static_argnums=(3,))
        def cx_chunk(accs, seg_full, x0, xc):
            acc_c, acc_x = accs
            seg_c = jax.lax.dynamic_slice_in_dim(seg_full, x0, xc, 0)
            flat = seg_c.reshape(-1)
            xw = jnp.broadcast_to(
                (x0 + jnp.arange(xc, dtype=jnp.float32))[:, None, None],
                seg_c.shape).reshape(-1)
            return (acc_c + jnp.bincount(flat, length=max_cells),
                    acc_x + jnp.bincount(flat, weights=xw, length=max_cells))

        acc_c = jnp.zeros((max_cells,), jnp.int32)
        acc_x = jnp.zeros((max_cells,), jnp.float32)
        for x0 in range(0, shape[0], 64):
            xc = min(64, shape[0] - x0)
            acc_c, acc_x = cx_chunk((acc_c, acc_x), seg, x0, xc)
        counts_lab = np.asarray(acc_c)
        cx = np.asarray(acc_x) / np.maximum(counts_lab, 1.0)
        labs_d = np.arange(1, min(n_found, max_cells - 1) + 1)
        owners = maj_truth[labs_d]
        from collections import Counter
        cnt = Counter(owners[has_t[labs_d]])
        dups = [lab for lab in labs_d
                if has_t[lab] and cnt[maj_truth[lab]] > 1]
        noise = [lab for lab in labs_d if not has_t[lab]]
        bdist = [min(abs(cx[lab] - b) for b in range(240, shape[0], 240))
                 for lab in dups]
        log(f"DIAG: unique truth covered={len(cnt)}, dup labels={len(dups)},"
            f" noise labels={len(noise)}")
        log(f"DIAG: dup boundary-distance percentiles "
            f"{np.percentile(bdist, [10, 50, 90]).round(1).tolist() if bdist else []}"
            f" (uniform would be ~[12, 60, 108])")
        log(f"DIAG: noise label sizes "
            f"{counts_lab[noise][:20].astype(int).tolist()}")
        dup_sizes = counts_lab[dups]
        log(f"DIAG: dup label size percentiles "
            f"{np.percentile(dup_sizes, [10, 50, 90]).round(0).tolist() if len(dups) else []}"
            f" (median true cell ~ "
            f"{int(np.median(counts_lab[labs_d][counts_lab[labs_d] > 0]))})")

    total_s = sum(timings.values())
    mvox = shape[0] * shape[1] * shape[2] / 1e6
    cold_total = sum(cold.values())
    result = {
        "seconds_total": round(total_s, 2),
        "mvox_per_s": round(mvox / total_s, 2),
        "cells_found": n_found,
        "cells_true": n_cells_true,
        "barcode_accuracy": round(accuracy, 4),
        "matched_cells": int(valid.sum()),
        "measure_path": "fused one-dispatch",
        **{k: round(v, 2) for k, v in timings.items()},
        "cold_pass": {
            "seconds_total": round(cold_total, 2),
            "mvox_per_s": round(mvox / cold_total, 2),
            **{k: round(v, 2) for k, v in cold.items()},
        },
    }
    return result


if __name__ == "__main__":
    import json

    kw = {}
    scale = os.environ.get("BENCH3D_SCALE")
    if scale:
        f = float(scale)
        kw["shape"] = (int(2020 * f) // 4 * 4, int(2020 * f) // 4 * 4,
                       int(170 * f) // 2 * 2)
    # measurement-chunk depth experiment knob (PROFILE_r03 lead 3)
    zc = os.environ.get("BENCH3D_ZCHUNK")
    if zc:
        kw["z_chunk"] = int(zc)
    print(json.dumps(run(**kw)))
