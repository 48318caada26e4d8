"""Time each hand-written kernel against the plain XLA version it replaces,
and the XLA-only stage formulations whose choice is a platform decision, on
the accelerator at the benchmark shapes.

    python tools/kernel_bench.py [--only nlm,e2e_nlm,lp2d,lp3d,stats_cm,topk,segstats]

Prints one JSON line per measurement (and writes them all to
``chiprun_out/kernel_bench.json``). Times are host-clock medians of
``--reps`` calls, each ended by ``jax.block_until_ready``, after one
warm-up call that compiles. Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

RESULTS = []


def emit(**kw):
    RESULTS.append(kw)
    print(json.dumps(kw), flush=True)


def timeit(fn, *args, reps=5):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts)) * 1e3, first


def _smooth_image(n, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:n, :n]
    img = (0.5 + 0.2 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
           + 0.01 * rng.randn(n, n))
    return img.astype(np.float32)


def bench_nlm(reps):
    import jax
    import jax.numpy as jnp

    from hiprfish_tpu.ops import denoise
    from hiprfish_tpu.ops.nlm_triton import denoise_nl_means_triton

    img = jnp.asarray(_smooth_image(2000))
    ref, t_xla, first = timeit(
        lambda x: denoise.denoise_nl_means(x, 0.02, 7, 11), img, reps=reps)
    emit(stage="nlm", impl="xla_shifted_sum_box", ms=t_xla,
         first_call_s=first)

    def _box_cumsum(im, size):
        half = size // 2
        p = jnp.pad(im, half, mode="edge")
        c = jnp.pad(jnp.cumsum(p, axis=0), ((1, 0), (0, 0)))
        rows = c[size:, :] - c[:-size, :]
        c2 = jnp.pad(jnp.cumsum(rows, axis=1), ((0, 0), (1, 0)))
        return (c2[:, size:] - c2[:, :-size]) / (size * size)

    orig = denoise._box_mean
    try:
        denoise._box_mean = _box_cumsum
        f_cs = jax.jit(lambda x: denoise.denoise_nl_means.__wrapped__(
            x, 0.02, 7, 11))
        _, t_cs, _ = timeit(f_cs, img, reps=reps)
    finally:
        denoise._box_mean = orig
    emit(stage="nlm", impl="xla_cumsum_box", ms=t_cs)
    for block, warps in ((32, 4), (64, 4), (64, 2), (64, 8), (128, 8)):
        try:
            out, t, first = timeit(
                lambda x, b=block, w=warps: denoise_nl_means_triton(
                    x, 0.02, 7, 11, b, w), img, reps=reps)
            err = float(jnp.max(jnp.abs(out - ref)))
            emit(stage="nlm", impl=f"triton_b{block}_w{warps}", ms=t,
                 first_call_s=first, max_abs_err_vs_xla=err)
        except Exception as e:  # a refused compile is a finding
            emit(stage="nlm", impl=f"triton_b{block}_w{warps}",
                 error=repr(e)[:400])


def bench_e2e_nlm(reps):
    """The 7-bit engine end to end (pipeline/fused.fov_step on the bench's
    2000^2 scene) with each NL-means implementation, in turns."""
    import jax

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    import bench
    from hiprfish_tpu.pipeline import fused
    from hiprfish_tpu.utils import platform

    clf = bench.classifier_7bit()
    arrays, static = fused.classifier_to_device_args(clf)
    fov, _ = bench.fov_7bit(2000, 400)
    stack = bench.to_device(fov)
    cfg = bench._seg_cfg()
    gpu = platform._POLICIES["gpu"]
    try:
        for kernel in ("xla", "triton", "triton", "xla"):
            platform._POLICIES["gpu"] = gpu._replace(nlm_kernel=kernel)
            jax.clear_caches()
            step = lambda: fused.fov_step(stack, arrays, cfg, 8192, static)
            jax.block_until_ready(step())
            t, t_sync = bench._time_steps(step, n_q=8, reps=reps)
            emit(stage="fov_step_7bit", impl=f"nlm_{kernel}",
                 ms_queued=t * 1e3, ms_per_call=t_sync * 1e3)
    finally:
        platform._POLICIES["gpu"] = gpu


def bench_lp2d(reps):
    import jax.numpy as jnp

    from hiprfish_tpu.ops import line_profile as lp

    img = jnp.asarray(_smooth_image(2000, 1))
    _, t, first = timeit(lambda x: lp.lp_cv_enhance_2d(x, 11, 9), img,
                         reps=reps)
    emit(stage="lp_cv_2d", impl="xla", ms=t, first_call_s=first,
         shape=[2000, 2000])


def bench_lp3d(reps):
    import jax.numpy as jnp

    from hiprfish_tpu.pipeline import segment3d

    rng = np.random.RandomState(2)
    shape = (2020, 256, 170)
    vol = jnp.asarray(rng.rand(*shape).astype(np.float32))
    _, t, first = timeit(
        lambda v: segment3d._lp_cv_3d_device(v, 11, 9, 9, 128, True), vol,
        reps=max(1, reps // 2))
    emit(stage="lp_cv_3d", impl="xla_selection_network", ms=t,
         first_call_s=first, shape=list(shape),
         full_volume_ms_est=t * 2020 / 256)


def _cell_labels(x, y, zc, pitch=36):
    """Ellipsoid-ish cells on a pitch grid, ids ascending with x (the
    3D pipeline's rank order)."""
    xs = np.arange(x)[:, None]
    ys = np.arange(y)[None, :]
    gx, gy = xs // pitch, ys // pitch
    cx, cy = gx * pitch + pitch // 2, gy * pitch + pitch // 2
    inside = ((xs - cx) / 11.0) ** 2 + ((ys - cy) / 7.0) ** 2 <= 1.0
    ids = np.where(inside, gx * (y // pitch + 1) + gy + 1, 0).astype(
        np.int32)
    return np.broadcast_to(ids[None], (zc, x, y)).copy()


def bench_stats_cm(reps):
    import jax
    import jax.numpy as jnp

    from hiprfish_tpu.pipeline import segment3d

    zc, x, y, c, mc = 2, 2020, 2020, 63, 16384
    lab = jnp.asarray(_cell_labels(x, y, zc))
    img = jax.random.uniform(jax.random.PRNGKey(0), (c, zc, x, y),
                             jnp.float32).astype(jnp.bfloat16)
    f = jax.jit(lambda l, i: segment3d._stats_cm(l, i, mc))
    out, t, first = timeit(f, lab, img, reps=reps)
    emit(stage="stats_cm", impl="xla_scatter_cells_dense_background", ms=t,
         first_call_s=first, planes=zc, shape=[x, y, c])

    def scatter_with_bg(l, i):
        idx = l.reshape(-1)
        s = jnp.zeros((c, mc), jnp.float32).at[:, idx].add(
            i.reshape(c, -1).astype(jnp.float32))
        n = jnp.zeros((mc,), jnp.float32).at[idx].add(1.0)
        return s, n

    _, t2, _ = timeit(jax.jit(scatter_with_bg), lab, img, reps=reps)
    emit(stage="stats_cm", impl="xla_scatter_add_cm_with_bg", ms=t2)


def bench_topk(reps):
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    d = jnp.asarray(rng.rand(8192, 8184).astype(np.float32))
    k = 25
    fa = jax.jit(lambda x: jax.lax.approx_max_k(-x, k, recall_target=0.99))
    fe = jax.jit(lambda x: jax.lax.top_k(-x, k))
    hlo = fa.lower(d).compile().as_text()
    lowered_to = sorted({op for op in ("sort", "topk", "TopK", "custom-call",
                                       "ApproxTopK") if op in hlo})
    (va, ia), ta, _ = timeit(fa, d, reps=reps)
    (ve, ie), te, _ = timeit(fe, d, reps=reps)
    same = bool(jnp.all(jnp.sort(ia, axis=1) == jnp.sort(ie, axis=1)))
    emit(stage="knn_select", impl="approx_max_k", ms=ta,
         shape=[8192, 8184, k], optimized_hlo_contains=lowered_to)
    emit(stage="knn_select", impl="top_k", ms=te, same_index_sets=same)


def bench_segstats(reps):
    import jax
    import jax.numpy as jnp

    from hiprfish_tpu.ops import segstats

    lab = jnp.asarray(_cell_labels(2000, 2000, 1, pitch=40)[0])
    img = jax.random.uniform(jax.random.PRNGKey(1), (2000, 2000, 63))
    ns = 8192
    fw = jax.jit(lambda l, i: segstats.label_stats(l, i, ns, width=256))
    fe = jax.jit(lambda l, i: segstats._label_stats_exact(
        l, i, None, None, ns))
    w, tw, _ = timeit(fw, lab, img, reps=reps)
    e, te, _ = timeit(fe, lab, img, reps=reps)
    emit(stage="label_stats", impl="xla_windowed_bf16_split", ms=tw,
         spill=bool(w.spill))
    emit(stage="label_stats", impl="xla_scatter_exact", ms=te,
         max_rel_err=float(jnp.max(jnp.abs(w.sums - e.sums))
                           / jnp.max(jnp.abs(e.sums))))


BENCHES = {"nlm": bench_nlm, "e2e_nlm": bench_e2e_nlm, "lp2d": bench_lp2d, "lp3d": bench_lp3d,
           "stats_cm": bench_stats_cm, "topk": bench_topk,
           "segstats": bench_segstats}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", default=",".join(BENCHES))
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()

    import jax

    from hiprfish_tpu.utils.platform import apply_compile_cache_env

    apply_compile_cache_env()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"kernel_bench: no GPU (found {dev.platform}); refusing to "
                 "time another device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit(device=dev.device_kind, count=len(jax.devices()),
         nvidia_smi=smi.strip(), jax=jax.__version__)
    for name in args.only.split(","):
        try:
            BENCHES[name](args.reps)
        except Exception as e:
            emit(stage=name, error=repr(e)[:600])
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_bench.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)


if __name__ == "__main__":
    main()
