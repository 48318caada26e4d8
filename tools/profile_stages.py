"""Per-stage timing of the fused 2D pipeline on the current device.

Each stage is jitted separately and timed steady-state on realistic
intermediates (the same 2000x2000 63-channel fixture bench.py uses), so the
numbers bound where the fused program spends its time. Stage sums exceed the
fused end-to-end latency slightly (cross-stage fusion is lost), which is fine
for targeting optimization work (VERDICT round-1 item 5).

Usage: python tools/profile_stages.py [--size 2000] [--cells 400]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hiprfish_tpu.utils.platform import apply_platform_env

apply_platform_env()


from _timing import device_time_ms


def timeit(fn, *args, reps=5, warmup=1):
    return device_time_ms(fn, *args, n=6, reps=reps, warmup=warmup)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2000)
    ap.add_argument("--cells", type=int, default=400)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--prefix", action="store_true",
                    help="time cumulative in-program prefixes of the fused "
                         "7-bit segmenter (stop_after=...) instead of "
                         "isolated stages — same attribution contract and "
                         "checksum caveats as profile_ecoli10b --prefix")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from hiprfish_tpu.config import SEVEN_BIT, ClassifierConfig, \
        SegmentationConfig
    from hiprfish_tpu.models import train as mtrain
    from hiprfish_tpu.models.classifier import train_classifier
    from hiprfish_tpu.ops import denoise as dn
    from hiprfish_tpu.ops import kmeans as km
    from hiprfish_tpu.ops import labeling as lab
    from hiprfish_tpu.ops import morphology as morph
    from hiprfish_tpu.ops import regionprops as rp
    from hiprfish_tpu.ops import register as reg
    from hiprfish_tpu.ops import watershed as ws
    from hiprfish_tpu.ops.line_profile import lp_cv_enhance_2d
    from hiprfish_tpu.pipeline import fused
    from hiprfish_tpu.utils import synthetic

    size, n_cells, max_cells = args.size, args.cells, 8192
    layout = SEVEN_BIT
    rng = np.random.RandomState(0)
    all_codes = list(range(1, 128))
    cell_codes = [all_codes[i % 127] for i in range(n_cells)]
    fov = synthetic.make_fov(layout, cell_codes, shape=(size, size), seed=1,
                             laser_shifts=[(0, 0), (2, -1), (0, 3), (-2, 0)],
                             cell_axes=(7.0, 12.0))
    stack = tuple(jax.device_put(np.asarray(a, np.float32))
                  for a in fov["stack"])
    jax.block_until_ready(stack)
    cfg = SegmentationConfig(**(
        {"scan_cap": int(os.environ["HIPRFISH_2D_SCAN_CAP"])}
        if os.environ.get("HIPRFISH_2D_SCAN_CAP") else {}))
    print(f"# fixture {size}x{size} on {jax.devices()[0].device_kind}",
          file=sys.stderr)

    if args.prefix:
        names = ["register", "nlm", "enhance", "kmeans", "seeds", "ccl",
                 "markers", "watershed", ""]
        prev = 0.0
        for nm in names:
            # segment_lpcv_device is a plain function (jitted only via its
            # fov_step caller) — jit here or it dispatches op-by-op.
            fn = jax.jit(lambda st, _nm=nm: fused.segment_lpcv_device(
                st, None, cfg, max_cells, True, _nm)[0])
            t, _ = device_time_ms(fn, stack, n=3, reps=3, warmup=1)
            label = nm or "FULL segment_lpcv_device"
            print(f"{label:<28} cum {t:8.1f} ms   delta {t - prev:8.1f} ms",
                  flush=True)
            prev = t
        return

    stages = {}

    # --- registration -------------------------------------------------
    @jax.jit
    def stage_register(stack):
        # mirrors fused.segment_lpcv_device:54-72 — phase correlation on
        # the centered register_crop window (full-frame FFTs here would
        # overstate this stage), clamped like the engine
        projections = [jnp.sum(img, axis=2) for img in stack]
        ref0 = projections[0]
        c = cfg.register_crop
        h, w = ref0.shape
        if c and h > c and w > c:
            r0, c0 = (h - c) // 2, (w - c) // 2
            _crop = lambda im: jax.lax.slice(im, (r0, c0), (r0 + c, c0 + c))
        else:
            _crop = lambda im: im
        cref = _crop(ref0)
        parts = [stack[0]]
        for i in range(1, len(stack)):
            s = reg.register_translation(cref, _crop(projections[i]))
            if cfg.clamp_shift:
                s = reg.clamp_shift(s, cfg.max_shift)
            shifted, _ = reg.apply_shift_2d(stack[i], s)
            parts.append(shifted)
        registered = jnp.concatenate(parts, axis=2)
        fov_sum = jnp.sum(registered, axis=2)
        return registered, fov_sum / jnp.maximum(jnp.max(fov_sum), 1e-12)

    stages["register+sum"], (registered, sum_norm) = timeit(
        stage_register, stack, reps=args.reps)

    # --- NLM ------------------------------------------------------------
    nlm = jax.jit(lambda x: dn.denoise_nl_means_auto(
        x, cfg.nlm_h, cfg.nlm_patch_size, cfg.nlm_patch_distance))
    stages["nlm"], den = timeit(nlm, sum_norm, reps=args.reps)

    # --- LP-CV enhancement ----------------------------------------------
    lpf = jax.jit(lambda x: lp_cv_enhance_2d(
        x, cfg.patch_size, cfg.phi_range))
    stages["lp_enhance"], enhanced = timeit(lpf, den, reps=args.reps)

    # --- KMeans masks ----------------------------------------------------
    km2 = jax.jit(lambda a, b: (
        km.brightest_cluster_mask(a, 2, cfg.kmeans_iters),
        km.brightest_cluster_mask(b, 2, cfg.kmeans_iters)))
    stages["kmeans_x2"], (bkg, fg_raw) = timeit(km2, den, enhanced,
                                                reps=args.reps)
    fg = fg_raw & bkg

    # --- seeds: opening + remove_small + fill_holes ----------------------
    @jax.jit
    def stage_seeds(fg):
        seeds_core = morph.binary_fill_holes(
            lab.remove_small_objects(morph.binary_opening(fg),
                                     cfg.lp_seed_min_size, 2))
        return seeds_core, seeds_core & morph.binary_fill_holes(fg)

    stages["seeds(open+rso+fill)"], (seeds_core, seed_mask) = timeit(
        stage_seeds, fg, reps=args.reps)

    sub = {}
    op = jax.jit(morph.binary_opening)
    sub["opening"], opened = timeit(op, fg, reps=args.reps)
    rso = jax.jit(lambda m: lab.remove_small_objects(
        m, cfg.lp_seed_min_size, 2))
    sub["remove_small_objects"], rso_out = timeit(rso, opened, reps=args.reps)
    fh = jax.jit(morph.binary_fill_holes)
    sub["fill_holes(core)"], _ = timeit(fh, rso_out, reps=args.reps)
    sub["fill_holes(fg)"], _ = timeit(fh, fg, reps=args.reps)

    # --- marker labeling --------------------------------------------------
    lbl = jax.jit(lambda m, b: lab.label(m, 2, cfg.ccl_max_iters)
                  * b.astype(jnp.int32))
    stages["label(markers)"], markers = timeit(lbl, seed_mask, bkg,
                                               reps=args.reps)

    # --- watershed ---------------------------------------------------------
    wsf = jax.jit(lambda e, m, f, b: ws.watershed(
        -(e * b), m, f & b, 1, cfg.watershed_max_iters))
    stages["watershed"], seg0 = timeit(wsf, enhanced, markers, fg, bkg,
                                       reps=args.reps)

    # --- filter_and_relabel (legacy scatter path, for comparison) ---------
    fr = jax.jit(lambda s: lab.filter_and_relabel(s, cfg.lp_cell_min_size))
    stages["filter_and_relabel(old)"], (seg, n_cells_found) = timeit(
        fr, seg0, reps=args.reps)
    seg = jnp.minimum(seg, max_cells - 1)

    # --- measure (legacy segment_sum, for comparison) ---------------------
    meas = jax.jit(lambda s, r: rp.mean_intensities(s, r, max_cells))
    stages["measure(segsum,old)"], avgint = timeit(meas, seg, registered,
                                                   reps=args.reps)

    # --- segstats stages (what the fused path actually runs) --------------
    from hiprfish_tpu.ops import segstats

    pre_segments = 2 * max_cells

    rs = jax.jit(lambda m: segstats.remove_small_objects_fast(
        m, cfg.lp_seed_min_size, 2))
    stages["rso_fast(new)"], _ = timeit(rs, jax.jit(morph.binary_opening)(fg),
                                        reps=args.reps)

    rk = jax.jit(lambda s: segstats.rank_labels(s, 2, cfg.ccl_max_iters))
    stages["rank_labels(new)"], (seg_seq, _n) = timeit(rk, seg0,
                                                       reps=args.reps)
    seg_seq = jnp.minimum(seg_seq, pre_segments - 1)

    @jax.jit
    def stage_stats_remap(s, r):
        stats = segstats.label_stats(s, r, pre_segments, width=1024)
        keep = (stats.counts >= cfg.lp_cell_min_size) \
            & (stats.border_hits == 0)
        keep = keep.at[0].set(False)
        final = jnp.cumsum(keep.astype(jnp.int32))
        remap = jnp.where(keep, jnp.minimum(final, max_cells - 1), 0)
        seg2 = segstats.label_lookup(s, remap, width=1024).astype(jnp.int32)
        means = stats.sums / jnp.maximum(stats.counts, 1.0)[:, None]
        av = jnp.zeros((max_cells, means.shape[1]), jnp.float32) \
            .at[remap].set(means)
        return seg2, final[-1], av.at[0].set(0.0)

    stages["stats+remap+measure(new)"], (_, _, avgint) = timeit(
        stage_stats_remap, seg_seq, registered, reps=args.reps)

    # --- classify ---------------------------------------------------------------
    spectra_lut = synthetic.fluorophore_spectra(layout)
    rows, code_strs = [], []
    for c in all_codes:
        spec = synthetic.barcode_spectrum(layout, c, spectra_lut)
        r = rng.uniform(0.7, 1.3, (50, 1)) * spec[None, :] \
            + rng.randn(50, layout.n_channels) * 0.02
        rows.append(np.clip(r, 0, None))
        code_strs += [layout.code_str(c)] * 50
    spectra = np.concatenate(rows).astype(np.float32)
    spectra = spectra / np.maximum(spectra.max(axis=1, keepdims=True), 1e-12)
    checks = mtrain.check_bits_for_codes(layout, code_strs)
    clf = train_classifier(jax.random.PRNGKey(0), layout, spectra, code_strs,
                           checks, ClassifierConfig(check_train_steps=60))
    clf_arrays, clf_static = fused.classifier_to_device_args(clf)
    (n_classes, blocks, check_slice, n_channels, k, temperature,
     check_blocks) = clf_static

    @jax.jit
    def stage_classify(avgint, clf_arrays):
        avgint_norm = avgint / jnp.maximum(
            jnp.max(avgint, axis=1, keepdims=True), 1e-12)
        return fused.classify_device(
            avgint_norm, clf_arrays["check_params"], check_blocks,
            clf_arrays.get("scaler_mean"), clf_arrays.get("scaler_scale"),
            clf_arrays["train_features"], clf_arrays["train_labels"],
            n_classes, blocks, check_slice, n_channels, k, temperature)

    stages["classify"], _ = timeit(stage_classify, avgint, clf_arrays,
                                   reps=args.reps)

    # --- fused end-to-end ----------------------------------------------------
    stepf = lambda: fused.fov_step(stack, clf_arrays, cfg, max_cells,
                                   clf_static)
    stages["TOTAL fused fov_step"], out = timeit(stepf, reps=args.reps)

    print(f"# cells found: {int(out.n_cells)}", file=sys.stderr)
    width = max(len(k) for k in stages)
    total = stages["TOTAL fused fov_step"]
    for k, v in stages.items():
        print(f"{k:<{width}}  {v:8.1f} ms")
    print("# seeds breakdown:")
    for k, v in sub.items():
        print(f"  {k:<{width}}  {v:8.1f} ms")
    print(f"# stage sum (excl. total): "
          f"{sum(v for k_, v in stages.items() if not k_.startswith('TOTAL')):.1f}"
          f" ms vs fused {total:.1f} ms")


if __name__ == "__main__":
    main()
