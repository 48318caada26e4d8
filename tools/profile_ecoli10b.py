"""Per-stage device timing of the fused 10-bit ecoli engine
(pipeline/fused_ecoli.segment_ecoli_device) on the current device — the
measurement harness behind the PROFILE notes' 10-bit table.

Usage: python tools/profile_ecoli10b.py [--size 2000] [--cells 400]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from hiprfish_tpu.utils.platform import apply_platform_env

apply_platform_env()

from _timing import device_time_ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2000)
    ap.add_argument("--cells", type=int, default=400)
    ap.add_argument("--spc", type=int, default=50)
    ap.add_argument("--prefix", action="store_true",
                    help="time cumulative in-program prefixes of the fused "
                         "engine (stop_after=...) instead of isolated "
                         "stages — deltas attribute in-program cost "
                         "including layout/fusion effects. Each prefix "
                         "pays a full-tensor checksum the full program "
                         "doesn't, so few-ms deltas are noise-level and "
                         "can be slightly negative")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from hiprfish_tpu.config import TEN_BIT, ClassifierConfig, \
        SegmentationConfig
    from hiprfish_tpu.models import train as mtrain
    from hiprfish_tpu.models.classifier import train_classifier
    from hiprfish_tpu.ops import kmeans as km
    from hiprfish_tpu.ops import labeling as lab
    from hiprfish_tpu.ops import morphology as morph
    from hiprfish_tpu.ops import register as reg
    from hiprfish_tpu.ops import segstats
    from hiprfish_tpu.ops import watershed as ws
    from hiprfish_tpu.pipeline import fused, fused_ecoli
    from hiprfish_tpu.pipeline.segment2d import _erode_labels_twice
    from hiprfish_tpu.utils import synthetic

    layout = TEN_BIT
    cfg = SegmentationConfig(**(
        {"scan_cap": int(os.environ["HIPRFISH_2D_SCAN_CAP"])}
        if os.environ.get("HIPRFISH_2D_SCAN_CAP") else {}))
    size, max_cells = args.size, 8192
    pre_segments = 2 * max_cells
    all_codes = list(range(1, 1024))
    cell_codes = [all_codes[(i * 37) % 1023] for i in range(args.cells)]
    fov = synthetic.make_fov(layout, cell_codes, shape=(size, size), seed=2,
                             laser_shifts=[(0, 0), (2, -1), (0, 3), (-2, 0),
                                           (1, 1)],
                             cell_axes=(9.0, 14.0))
    stack = tuple(jax.device_put(np.asarray(a, np.float32))
                  for a in fov["stack"])
    jax.block_until_ready(stack)
    print(f"# fixture {size}^2 x 5 lasers on "
          f"{jax.devices()[0].device_kind}", file=sys.stderr)

    if args.prefix:
        names = ["register", "kmeans", "opening", "ccl", "depth", "dhist",
                 "markers", "watershed", "eroded", "stats", ""]
        all_names = list(names)
        if os.environ.get("HIPRFISH_PREFIX_STAGES"):
            sel = os.environ["HIPRFISH_PREFIX_STAGES"].split(",")
            names = [n for n in names if n in sel or (n == "" and "full" in sel)]
        # A delta is only meaningful when the immediately preceding prefix
        # in the canonical list was also timed; otherwise it would silently
        # aggregate the skipped stages.
        prev, prev_name = 0.0, None
        for nm in names:
            if nm == "":
                fn = lambda st: fused_ecoli.segment_ecoli_device(
                    st, cfg, max_cells)[1]
            else:
                fn = (lambda st, _nm=nm: fused_ecoli.segment_ecoli_device(
                    st, cfg, max_cells, _nm))
            t, _ = device_time_ms(fn, stack, n=3, reps=3, warmup=1)
            label = nm or "FULL segment_ecoli_device"
            idx = all_names.index(nm)
            contiguous = (idx == 0) or (prev_name == all_names[idx - 1])
            delta = (f"delta {t - prev:8.1f} ms" if contiguous
                     else f"delta {t - prev:8.1f} ms (spans skipped stages)")
            print(f"{label:<28} cum {t:8.1f} ms   {delta}", flush=True)
            prev, prev_name = t, nm
        return


    rng = np.random.RandomState(0)
    lut = synthetic.fluorophore_spectra(layout)
    base = np.stack([synthetic.barcode_spectrum(layout, c, lut)
                     for c in all_codes])
    spc = args.spc
    gains = rng.uniform(0.7, 1.3, (1023, spc, 1)).astype(np.float32)
    noise = rng.randn(1023, spc, layout.n_channels).astype(np.float32) * 0.02
    spectra = np.clip(gains * base[:, None, :] + noise, 0, None)
    spectra = spectra.reshape(1023 * spc, layout.n_channels)
    spectra /= np.maximum(spectra.max(axis=1, keepdims=True), 1e-12)
    spectra = np.concatenate(
        [spectra, np.diff(spectra[:, :32], axis=1)], axis=1)
    code_strs = [layout.code_str(c) for c in all_codes for _ in range(spc)]
    checks = mtrain.check_bits_for_codes(layout, code_strs)
    clf = train_classifier(
        jax.random.PRNGKey(0), layout, spectra, code_strs, checks,
        ClassifierConfig(check_train_steps=60), violet_derivative=True)
    clf_arrays, clf_static = fused.classifier_to_device_args(clf)

    stages = {}

    def timeit(name, fn, *xs, reps=3):
        stages[name], out = device_time_ms(fn, *xs, n=3, reps=reps, warmup=1)
        print(f"{name:<36} {stages[name]:8.1f} ms", flush=True)
        return out

    # -- registration + sum + log --
    @jax.jit
    def regsum(stack):
        projections = [jnp.max(img, axis=2) for img in stack]
        ref0 = projections[0]
        c = cfg.register_crop
        h, w = ref0.shape
        r0, c0 = (h - c) // 2, (w - c) // 2
        _crop = lambda im: jax.lax.slice(im, (r0, c0), (r0 + c, c0 + c))
        cref = _crop(ref0)
        parts = [stack[0]]
        overlap = jnp.ones(ref0.shape, bool)
        for i in range(1, len(stack)):
            s = reg.register_translation(cref, _crop(projections[i]))
            s = reg.clamp_shift(s, cfg.max_shift)
            shifted, mask = reg.apply_shift_2d(stack[i], s)
            parts.append(shifted)
            overlap = overlap & mask
        registered = jnp.concatenate(parts, axis=2) * overlap[:, :, None]
        fov_sum = jnp.sum(registered, axis=2)
        return registered, jnp.log(fov_sum + 1e-2)

    registered, image_cn = timeit("register+sum+log", regsum, stack)

    fg = timeit("kmeans fg(2)", jax.jit(
        lambda im: km.brightest_cluster_mask(im, 2, cfg.kmeans_iters)),
        image_cn)
    interior0 = timeit("kmeans interior(3)", jax.jit(
        lambda im: km.brightest_cluster_mask(im, 3, cfg.kmeans_iters)),
        image_cn)
    interior1 = timeit("remove_small_holes", jax.jit(
        lambda m: segstats.remove_small_holes_fast(m, 64)), interior0)
    interior = timeit("opening", jax.jit(morph.binary_opening), interior1)

    def ccl_filter(m):
        comp0, _ = segstats.rank_labels(
            lab.label(m, 2, cfg.ccl_max_iters), 2, cfg.ccl_max_iters)
        comp0 = jnp.minimum(comp0, pre_segments - 1)
        cstats = segstats.label_stats(comp0, None, pre_segments)
        keep_tbl = jnp.where(cstats.counts >= 50,
                             jnp.arange(pre_segments, dtype=jnp.float32),
                             0.0).at[0].set(0.0)
        return segstats.label_lookup(comp0, keep_tbl).astype(jnp.int32)

    comp = timeit("CCL+rank+stats+filter", jax.jit(ccl_filter), interior)
    cell_sm = comp > 0

    kmax = cfg.max_erosion_iters

    def depth_fn(cell_sm):
        depth = cell_sm.astype(jnp.int32)
        m = cell_sm
        for _ in range(kmax - 1):
            m = morph.binary_erosion(m) & cell_sm
            depth = depth + m
        return depth

    depth = timeit(f"erosion depth ({kmax})", jax.jit(depth_fn), cell_sm)

    def dstats_fn(comp, depth):
        return segstats.label_stats(
            comp, None, pre_segments, aux=jnp.clip(depth, 0, kmax),
            aux_classes=kmax + 1).aux_hist

    hist = timeit("depth histogram", jax.jit(dstats_fn), comp, depth)

    def seeds_fn(comp, depth, hist):
        area_k = jnp.cumsum(hist[:, ::-1], axis=1)[:, ::-1][:, 1:]
        small = area_k < cfg.seed_area_max
        k_seed = jnp.argmax(small, axis=1).astype(jnp.int32)
        seed_area = jnp.take_along_axis(area_k, k_seed[:, None], axis=1)[:, 0]
        valid = (seed_area >= cfg.seed_min_size) \
            & (jnp.arange(pre_segments) > 0)
        ktbl = jnp.where(valid, k_seed, kmax + 1).astype(jnp.float32)
        k_pix = segstats.label_lookup(comp, ktbl)
        seed_mask = (depth.astype(jnp.float32) > k_pix) & (comp > 0)
        markers, _ = segstats.rank_labels(
            lab.label(seed_mask, 2, cfg.ccl_max_iters), 2, cfg.ccl_max_iters)
        return jnp.minimum(markers, pre_segments - 1)

    markers = timeit("seed lookup + CCL+rank", jax.jit(seeds_fn), comp,
                     depth, hist)

    seg_ws = timeit("watershed", jax.jit(
        lambda im, mk, m: ws.watershed(-im, mk, m, 1,
                                       cfg.watershed_max_iters)),
        image_cn, markers, fg)

    eroded = timeit("erode labels x2", jax.jit(_erode_labels_twice), seg_ws)

    def stats_fn(seg_ws, registered, eroded):
        return segstats.label_stats(
            seg_ws, registered, pre_segments, moments=True,
            image_mask=(eroded > 0).astype(jnp.float32)).counts

    timeit("fused stats (moments+95ch masked)", jax.jit(stats_fn), seg_ws,
           registered, eroded)

    n_classes, blocks, check_slice, n_channels, k, temperature, \
        check_blocks = clf_static

    def classify_fn(avgint_norm):
        lo, hi = blocks[0]
        feats = jnp.concatenate(
            [avgint_norm, jnp.diff(avgint_norm[:, lo:hi], axis=1)], axis=1)
        return fused.classify_device(
            feats, clf_arrays["check_params"], check_blocks,
            clf_arrays.get("scaler_mean"), clf_arrays.get("scaler_scale"),
            clf_arrays["train_features"], clf_arrays["train_labels"],
            n_classes, blocks, check_slice, n_channels, k, temperature)[0]

    avg = jnp.abs(jax.random.normal(jax.random.PRNGKey(1),
                                    (max_cells, layout.n_channels)))
    avg = avg / jnp.max(avg, axis=1, keepdims=True)
    timeit("classify (8192 x 1023-cls kNN)", jax.jit(classify_fn), avg)

    # free the stage intermediates before the full program (holding them
    # alongside the fused program's own buffers OOMs the chip)
    del registered, image_cn, fg, interior0, interior1, interior, comp, \
        cell_sm, depth, hist, markers, seg_ws, eroded, avg

    def full(stack):
        return fused_ecoli.fov_step_ecoli(stack, clf_arrays, cfg, max_cells,
                                          clf_static)[0]

    try:
        timeit("TOTAL fov_step_ecoli", full, stack)
    except Exception as e:  # noqa: BLE001
        print(f"TOTAL failed: {type(e).__name__}", flush=True)


if __name__ == "__main__":
    main()
