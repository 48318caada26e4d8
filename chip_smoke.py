"""Smoke test of the whole system on one GPU, through the entry points a
user calls, at the sizes users run.

    python chip_smoke.py

Phases (each prints its wall time and the path it took; a failed gate
raises, so the script exits non-zero and prints no result line):

  0  device: refuses anything but a GPU; prints the card.
  1  7-bit engine (pipeline/fused.fov_step): a 2000x2000 FOV, 4 lasers,
     63 channels, 400 planted cells, 127-code classifier; and the
     out-of-distribution scene. Gates: barcode accuracy >= 0.99 on matched
     cells, >= 380 of 400 planted cells matched.
  2  10-bit path: cli.measure on per-laser .npy files of a 2000x2000
     95-channel FOV (artifacts, per-cell spectra against the planted
     barcodes); then fused_ecoli.fov_step_ecoli with the 1023-class
     classifier (same gates as phase 1).
  3  3D volume: tools/bench3d.run at 2020x2020x170, cold and warm pass,
     with the fused one-dispatch measurement. Gates: exactly 9408/9408
     cells, accuracy >= 0.99.
  4  comparisons on the card, each printed beside its tolerance: the NLM
     kernel against the XLA reference; segstats' windowed path against the
     exact scatter; the fused 3D measurement against the per-chunk path;
     classifier calls at default vs highest matmul precision; calls from
     the bf16 registered cube vs f32.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SIZE = 2000                  # FOV side, pixels
N_CELLS = 400                # planted cells per FOV
MIN_MATCHED = 380
MIN_ACC = 0.99
SHAPE_3D = (2020, 2020, 170)
CELLS_3D = 9408              # planted cells of SHAPE_3D


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  gate {'pass' if ok else 'FAIL'}: {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def compare(name: str, err: float, tol: float) -> None:
    check(err <= tol, f"{name}: max error {err:.3e} <= tolerance {tol:.1e}")


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== phase {self.name}", flush=True)
        self.t0 = time.time()
        return self

    def __exit__(self, exc_type, *_):
        status = "ok" if exc_type is None else "FAILED"
        print(f"== phase {self.name}: {status} in "
              f"{time.time() - self.t0:.1f} s", flush=True)
        return False


def phase0_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    print(f"device_kind={dev.device_kind} jax={jax.__version__} "
          f"bytes_limit={limit} count={len(jax.devices())}")
    print(f"nvidia-smi: {smi}", flush=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _accuracy_gates(label, seg, truth, codes_pred, cell_codes, clf, layout,
                    n_found, max_cells):
    import numpy as np

    import bench

    correct, matched = bench._barcode_accuracy(
        np.asarray(seg), truth, np.asarray(codes_pred), cell_codes,
        list(clf.codebook), layout, int(n_found), max_cells)
    acc = correct / max(matched, 1)
    print(f"  {label}: {int(n_found)} cells found, {matched}/{N_CELLS} "
          f"planted matched, accuracy {acc:.4f} ({correct}/{matched})")
    check(acc >= MIN_ACC, f"{label} accuracy {acc:.4f} >= {MIN_ACC}")
    check(matched >= MIN_MATCHED,
          f"{label} matched {matched} >= {MIN_MATCHED}")


def phase1_7bit(state):
    import threading

    import jax

    import bench
    from hiprfish_tpu.config import SEVEN_BIT, SegmentationConfig
    from hiprfish_tpu.pipeline import fused
    from hiprfish_tpu.utils.platform import policy

    max_cells = 8192
    cfg = SegmentationConfig()
    clf = bench.classifier_7bit()
    clf_arrays, clf_static = fused.classifier_to_device_args(clf)
    warm = threading.Thread(target=lambda: fused.fov_step.lower(
        bench.stack_specs(SEVEN_BIT, SIZE), clf_arrays, cfg, max_cells,
        clf_static).compile())
    warm.start()
    fov, codes = bench.fov_7bit(SIZE, N_CELLS)
    ood, ood_codes = bench.fov_7bit_ood(SIZE, N_CELLS)
    warm.join()
    print(f"  path: fused.fov_step, NLM kernel {policy().nlm_kernel}, "
          f"registered cube {cfg.registered_dtype}")
    stack = bench.to_device(fov)
    t0 = time.time()
    out = jax.block_until_ready(fused.fov_step(stack, clf_arrays, cfg,
                                               max_cells, clf_static))
    print(f"  first call {time.time() - t0:.2f} s")
    _accuracy_gates("7-bit", out.segmentation, fov["truth_labels"],
                    out.code_idx, codes, clf, SEVEN_BIT, out.n_cells,
                    max_cells)
    t, t_sync = bench._time_steps(lambda: fused.fov_step(
        stack, clf_arrays, cfg, max_cells, clf_static), n_q=4, reps=3)
    print(f"  steady state {t * 1e3:.1f} ms/FOV queued, "
          f"{t_sync * 1e3:.1f} ms per call")
    out_o = jax.block_until_ready(fused.fov_step(
        bench.to_device(ood), clf_arrays, cfg, max_cells, clf_static))
    _accuracy_gates("7-bit OOD", out_o.segmentation, ood["truth_labels"],
                    out_o.code_idx, ood_codes, clf, SEVEN_BIT, out_o.n_cells,
                    max_cells)
    state["7b"] = dict(stack=stack, out=out, clf=clf, clf_arrays=clf_arrays,
                       clf_static=clf_static, cfg=cfg, max_cells=max_cells)


def _cli_measure_checks(tmp, fov, codes, layout):
    """Artifacts of cli.measure, and each found cell's spectrum against
    the planted barcodes."""
    import numpy as np

    import bench
    from hiprfish_tpu.utils import synthetic

    sample = os.path.join(tmp, "smoke_enc_5")
    for suffix in ("_avgint.csv", "_avgint_norm.csv", "_seg.npy",
                   "_seg.png"):
        check(os.path.exists(sample + suffix), f"artifact {suffix} written")
    avg = np.loadtxt(sample + "_avgint.csv", delimiter=",", ndmin=2)
    seg = np.load(sample + "_seg.npy")
    n = avg.shape[0]
    check(n == int(seg.max()), f"avgint rows {n} == cells in _seg.npy")
    majority = bench.majority_truth(seg, fov["truth_labels"])
    lut = synthetic.fluorophore_spectra(layout)
    planted = sorted(set(codes))
    spec = np.stack([synthetic.barcode_spectrum(layout, c, lut)
                     for c in planted])
    spec /= np.linalg.norm(spec, axis=1, keepdims=True)
    a = avg / (np.linalg.norm(avg, axis=1, keepdims=True) + 1e-30)
    cos = a @ spec.T
    good = 0
    min_cos = 1.0
    for lab in range(1, n + 1):
        tid = majority.get(lab)
        if tid is None:
            continue
        own = planted.index(codes[tid - 1])
        c = cos[lab - 1]
        min_cos = min(min_cos, float(c[own]))
        good += int(np.argmax(c) == own and c[own] > 0.99)
    share = good / max(n, 1)
    print(f"  cli.measure: {n} cells, {good} match their planted barcode "
          f"(nearest planted spectrum, cos > 0.99; min own cos "
          f"{min_cos:.4f}), {len(majority)} overlap a planted cell")
    check(share >= 0.95, f"cli.measure share matched {share:.4f} >= 0.95")


def phase2_10bit(state):
    import jax
    import numpy as np

    import bench
    from hiprfish_tpu.cli import measure as cli_measure
    from hiprfish_tpu.config import TEN_BIT, SegmentationConfig
    from hiprfish_tpu.pipeline import fused, fused_ecoli
    from hiprfish_tpu.utils.platform import policy

    fov, codes = bench.fov_10bit(SIZE, N_CELLS)
    print(f"  path: cli.measure -> {policy().cli_engine} engine")
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".smoke_") as tmp:
        names = []
        for laser, plane in zip(TEN_BIT.lasers, fov["stack"]):
            name = os.path.join(tmp, f"smoke_enc_5_{laser}.npy")
            np.save(name, np.asarray(plane, np.float32))
            names.append(name)
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            t0 = time.time()
            cli_measure.main(["-i", *[os.path.basename(n) for n in names],
                              "-c", "F"])
            print(f"  cli.measure (cold process state) "
                  f"{time.time() - t0:.1f} s")
        finally:
            os.chdir(cwd)
        _cli_measure_checks(tmp, fov, codes, TEN_BIT)

    max_cells = 8192
    cfg = SegmentationConfig()
    t0 = time.time()
    clf, train_rows, train_s = bench.classifier_10bit(200)
    print(f"  1023-class classifier: {train_rows} training rows, "
          f"kNN matrix {clf.train_features.shape}, {time.time() - t0:.1f} s")
    clf_arrays, clf_static = fused.classifier_to_device_args(clf)
    print("  path: fused_ecoli.fov_step_ecoli")
    stack = bench.to_device(fov)
    t0 = time.time()
    seg, n, norm, code_idx, _ = jax.block_until_ready(
        fused_ecoli.fov_step_ecoli(stack, clf_arrays, cfg, max_cells,
                                   clf_static))
    print(f"  first call {time.time() - t0:.2f} s")
    _accuracy_gates("10-bit", seg, fov["truth_labels"], code_idx, codes,
                    clf, TEN_BIT, n, max_cells)
    t, t_sync = bench._time_steps(lambda: fused_ecoli.fov_step_ecoli(
        stack, clf_arrays, cfg, max_cells, clf_static), n_q=4, reps=3)
    print(f"  steady state {t * 1e3:.1f} ms/FOV queued, "
          f"{t_sync * 1e3:.1f} ms per call")
    state["10b"] = dict(stack=stack, n=n, norm=norm, code_idx=code_idx,
                        clf=clf, clf_arrays=clf_arrays,
                        clf_static=clf_static, cfg=cfg, max_cells=max_cells)


def phase3_3d():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bench3d

    print(f"  path: tools/bench3d.run {SHAPE_3D}, fused measure, warm pass")
    res = bench3d.run(shape=SHAPE_3D, verbose=True)
    print("  " + json.dumps(res))
    check(res["measure_path"] == "fused one-dispatch",
          f"measure path {res['measure_path']!r} is the fused one-dispatch")
    check(res["cells_true"] == CELLS_3D,
          f"3D planted cells {res['cells_true']} == {CELLS_3D}")
    check(res["cells_found"] == res["cells_true"],
          f"3D cells found {res['cells_found']} == planted "
          f"{res['cells_true']}")
    check(res["barcode_accuracy"] >= MIN_ACC,
          f"3D accuracy {res['barcode_accuracy']:.4f} >= {MIN_ACC}")


def _cmp_nlm(state):
    import jax.numpy as jnp

    from hiprfish_tpu.ops import denoise
    from hiprfish_tpu.ops.nlm_triton import denoise_nl_means_triton
    from hiprfish_tpu.utils.platform import policy

    s = sum(jnp.sum(p, axis=2) for p in state["7b"]["stack"])
    s = s / jnp.max(s)
    ref = denoise.denoise_nl_means(s, 0.02, 7, 11)
    if policy().nlm_kernel == "triton":
        got = denoise_nl_means_triton(s, 0.02, 7, 11)
        compare(f"NLM triton kernel vs XLA reference ({SIZE}^2, abs)",
                float(jnp.max(jnp.abs(got - ref))), 1e-5)


def _cmp_segstats(state):
    import jax.numpy as jnp
    import numpy as np

    from hiprfish_tpu.ops import segstats
    from hiprfish_tpu.utils.platform import policy

    print(f"  segstats: windowed one-hot dots, bf16 split "
          f"{policy().bf16_dots}")
    seg = state["7b"]["out"].segmentation
    img = jnp.concatenate(state["7b"]["stack"], axis=2)       # (H, W, 63)
    rng = np.random.RandomState(0)
    h, w = seg.shape
    aux = jnp.asarray(rng.randint(0, 7, (h, w)).astype(np.int32))
    mask = jnp.asarray((rng.rand(h, w) > 0.5).astype(np.float32))
    ns = 1024
    exact = segstats._label_stats_exact(seg, img, aux, mask, ns, 7, True)
    fast = segstats.label_stats(seg, img, ns, width=256, aux=aux,
                                aux_classes=7, moments=True,
                                image_mask=mask)
    check(not bool(fast.spill), "segstats window did not spill")
    for name in ("counts", "border_hits", "aux_hist", "mask_counts"):
        compare(f"label_stats {name} (exact)",
                float(jnp.max(jnp.abs(getattr(fast, name)
                                      - getattr(exact, name)))), 0.0)

    def rel(a, b):
        return float(jnp.max(jnp.abs(a - b) / jnp.maximum(jnp.abs(b), 1.0)))

    compare("label_stats channel sums (rel)", rel(fast.sums, exact.sums),
            2e-4)
    compare("label_stats moments (rel)", rel(fast.moments, exact.moments),
            2e-4)
    tbl = jnp.asarray(rng.randint(0, 1000, ns).astype(np.float32)).at[0].set(0)
    got = segstats.label_lookup(seg, tbl, width=256, out_dtype=jnp.int32)
    want = tbl[jnp.clip(seg, 0, ns - 1)].astype(jnp.int32)
    compare("label_lookup vs gather (exact)",
            float(jnp.max(jnp.abs(got - want))), 0.0)
    # a far-apart id in one band must spill and fall back to the exact path
    seg2 = seg.at[5, 5].set(1).at[5, 6].set(ns - 1)
    f2 = segstats.label_stats(seg2, img, ns, width=256)
    e2 = segstats._label_stats_exact(seg2, img, None, None, ns)
    check(bool(f2.spill), "window spill detected")
    compare("label_stats after spill fallback (rel)", rel(f2.sums, e2.sums),
            2e-4)


def _cmp_3d_measure():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hiprfish_tpu.config import SEVEN_BIT
    from hiprfish_tpu.pipeline import segment3d
    from hiprfish_tpu.utils import synthetic
    from hiprfish_tpu.utils import synthetic3d as s3

    shape = SHAPE_3D
    codes = list(range(1, 128))
    spec = s3.VolumeSpec(shape=shape, seed=5,
                         spacing=(36, 36, min(52, shape[2])))
    lut = jnp.asarray(np.stack([synthetic.barcode_spectrum(SEVEN_BIT, c)
                                for c in codes]), jnp.float32)
    key = jax.random.key(1, impl="rbg")

    def loader(z0, zc):
        return s3.channel_chunk_cm(spec, len(codes), z0, zc, lut, key,
                                   jnp.bfloat16)

    labels = jnp.concatenate(
        [s3.truth_chunk(spec, len(codes), z0, min(34, shape[2] - z0))[0]
         for z0 in range(0, shape[2], 34)], axis=2)         # (X, Y, Z)
    mc = 16384
    fused_avg = segment3d.make_fused_measure(loader, shape, 2, 63, mc)(
        jnp.transpose(labels, (2, 0, 1)))
    streamed = segment3d.measure_volume_streamed(
        labels, loader, shape[2], 2, 63, mc, channels_major=True)
    a, b = np.asarray(fused_avg), np.asarray(streamed)
    # row 0 is the background's mean
    cells_a = np.flatnonzero(np.abs(a[1:]).sum(axis=1) > 0)
    cells_b = np.flatnonzero(np.abs(b[1:]).sum(axis=1) > 0)
    check(np.array_equal(cells_a, cells_b) and len(cells_a) == spec.n_cells,
          f"fused and per-chunk 3D measure see the same {len(cells_a)} "
          f"cells (planted {spec.n_cells})")
    compare("3D fused vs per-chunk measure spectra (rel)",
            float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))),
            1e-5)


def _calls(kind, st, precision=None):
    import contextlib

    import jax
    import jax.numpy as jnp
    import numpy as np

    from hiprfish_tpu.pipeline import fused

    (n_classes, blocks, check_slice, n_channels, k, temperature,
     check_blocks) = st["clf_static"]
    arr = st["clf_arrays"]
    if kind == "7b":
        feats, n = st["out"].avgint_norm, st["out"].n_cells
    else:
        lo, hi = blocks[0]
        norm = st["norm"]
        feats = jnp.concatenate([norm, jnp.diff(norm[:, lo:hi], axis=1)],
                                axis=1)
        n = st["n"]

    @jax.jit
    def run(f, n):
        return fused.classify_capped(
            f, n, 2048, arr["check_params"], check_blocks,
            arr.get("scaler_mean"), arr.get("scaler_scale"),
            arr["train_features"], arr["train_labels"], n_classes, blocks,
            check_slice, n_channels, k, temperature)[0]

    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:
        out = np.asarray(run(feats, n))
    return out[1:int(n) + 1]


def _cmp_precision(state):
    import numpy as np

    for kind in ("7b", "10b"):
        a = _calls(kind, state[kind])
        b = _calls(kind, state[kind], "highest")
        compare(f"{kind} classifier calls, default vs highest precision "
                f"(differing of {len(a)})", float(np.sum(a != b)), 0.0)


def _cmp_bf16_cube(state):
    import jax
    import numpy as np

    from hiprfish_tpu.pipeline import fused, fused_ecoli

    st = state["7b"]
    cfg32 = dataclasses.replace(st["cfg"], registered_dtype="float32")
    o32 = jax.block_until_ready(fused.fov_step(
        st["stack"], st["clf_arrays"], cfg32, st["max_cells"],
        st["clf_static"]))
    o16 = st["out"]
    n16, n32 = int(o16.n_cells), int(o32.n_cells)
    check(n16 == n32, f"7-bit cells bf16 cube {n16} == f32 cube {n32}")
    compare("7-bit calls, bf16 vs f32 registered cube (differing)",
            float(np.sum(np.asarray(o16.code_idx)[1:n16 + 1]
                         != np.asarray(o32.code_idx)[1:n32 + 1])), 0.0)
    st = state["10b"]
    cfg32 = dataclasses.replace(st["cfg"], registered_dtype="float32")
    _, n32, _, c32, _ = jax.block_until_ready(fused_ecoli.fov_step_ecoli(
        st["stack"], st["clf_arrays"], cfg32, st["max_cells"],
        st["clf_static"]))
    n16 = int(st["n"])
    check(n16 == int(n32), f"10-bit cells bf16 cube {n16} == f32 cube "
                           f"{int(n32)}")
    compare("10-bit calls, bf16 vs f32 registered cube (differing)",
            float(np.sum(np.asarray(st["code_idx"])[1:n16 + 1]
                         != np.asarray(c32)[1:n16 + 1])), 0.0)


def phase4_compare(state):
    _cmp_nlm(state)
    _cmp_segstats(state)
    _cmp_precision(state)
    _cmp_bf16_cube(state)
    _cmp_3d_measure()


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "hiprfish_tpu")):
        print("chip_smoke: the hiprfish_tpu package is not next to this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from hiprfish_tpu.utils.platform import apply_compile_cache_env

    apply_compile_cache_env()
    t_start = time.time()
    state = {}
    with Phase("0 device"):
        device = phase0_device()
    with Phase("1 7-bit engine + OOD"):
        phase1_7bit(state)
    with Phase("2 10-bit cli.measure + fov_step_ecoli"):
        phase2_10bit(state)
    with Phase("3 3D volume"):
        phase3_3d()
    with Phase("4 comparisons"):
        phase4_compare(state)
    print(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
