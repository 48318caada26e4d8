"""FOV-batch data parallelism: the sharded replacement for Snakemake fan-out.

A batch of FOVs is stacked on a leading axis and sharded over the mesh's
'fov' axis with shard_map; inside each shard the fused per-FOV pipeline
(pipeline/fused.fov_step) runs UNBATCHED under lax.map — so every device
executes the exact single-FOV program, Pallas kernels included (a vmap
formulation would silently fall back to the slower XLA kernels: Pallas calls
have no batching rule). One compiled program processes B FOVs across all
chips; the classifier reference matrix is replicated.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from hiprfish_tpu.config import SegmentationConfig
from hiprfish_tpu.pipeline import fused


def batched_fov_step(mesh, cfg: SegmentationConfig, max_cells: int,
                     clf_static, denoise: bool = True):
    """Compiled batched pipeline: stacks (B, H, W, C_l) per laser, sharded
    over 'fov'. Returns a function (stack_tuple, clf_arrays) -> FovResult
    with leading batch dims. B must be a multiple of the mesh's 'fov' size;
    each device sweeps its local FOVs sequentially at single-FOV speed."""
    from jax import shard_map

    def local(stack, clf_arrays):
        def step(st):
            return fused.fov_step(st, clf_arrays, cfg, max_cells,
                                  clf_static, denoise)
        return jax.lax.map(step, stack)

    run = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("fov"), P()),
        out_specs=P("fov"),
        check_vma=False,
    ))

    def call(stack, clf_arrays):
        sharding = NamedSharding(mesh, P("fov"))
        stack = tuple(jax.device_put(s, sharding) for s in stack)
        clf_arrays = jax.device_put(
            clf_arrays, NamedSharding(mesh, P()))
        return run(stack, clf_arrays)

    return call


def batched_fov_step_ecoli(mesh, cfg: SegmentationConfig, max_cells: int,
                           clf_static, classify_cap: int = 2048):
    """10-bit counterpart of batched_fov_step: the fused 1023-class engine
    (pipeline/fused_ecoli.fov_step_ecoli) swept per device under lax.map
    with the batch sharded over 'fov'. Returns (stack_tuple, clf_arrays) ->
    (seg, n_cells, avgint_norm, code_idx, max_prob), leading batch dims."""
    from jax import shard_map

    from hiprfish_tpu.pipeline import fused_ecoli

    def local(stack, clf_arrays):
        def step(st):
            return fused_ecoli.fov_step_ecoli(st, clf_arrays, cfg,
                                              max_cells, clf_static,
                                              classify_cap)

        return jax.lax.map(step, stack)

    run = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("fov"), P()),
        out_specs=P("fov"),
        check_vma=False,
    ))

    def call(stack, clf_arrays):
        sharding = NamedSharding(mesh, P("fov"))
        stack = tuple(jax.device_put(s, sharding) for s in stack)
        clf_arrays = jax.device_put(clf_arrays, NamedSharding(mesh, P()))
        return run(stack, clf_arrays)

    return call


def run_batch_pipeline(samples, clf, cfg: SegmentationConfig | None = None,
                       max_cells: int = 4096, batch: int | None = None,
                       mesh=None, denoise: bool = True, out_dir: str = "."):
    """Production batch runner: prefetch-decode FOVs, run the fused pipeline
    in sharded batches, write the reference-format artifacts.

    Args:
      samples: list of (sample_name, [per-laser filenames]).
      clf: SpectralClassifier.
      batch: FOVs per device batch (defaults to mesh 'fov' size).
    Returns {sample_name: (n_cells, barcode list)}.
    """
    import os

    import numpy as np

    from hiprfish_tpu.config import SegmentationConfig as _SC
    from hiprfish_tpu.io import outputs
    from hiprfish_tpu.io.loader import FovPrefetcher
    from hiprfish_tpu.parallel import mesh as meshlib

    cfg = cfg or _SC()
    if mesh is None:
        mesh = meshlib.make_mesh(tile=1)
    if batch is None:
        batch = mesh.shape["fov"]
    clf_arrays, clf_static = fused.classifier_to_device_args(clf)
    run = batched_fov_step(mesh, cfg, max_cells, clf_static, denoise)

    def run_with_oom_backoff(batched):
        """Device OOM recovery (utils/oom.py): split the batch into
        mesh-aligned halves and run them sequentially — same per-device
        program at half the live batch footprint."""
        from hiprfish_tpu.utils import oom as oomlib

        try:
            out = run(batched, clf_arrays)
            jax.tree_util.tree_map(
                lambda x: x.block_until_ready(), out)
            return [out]
        except Exception as e:  # noqa: BLE001 - filtered below
            b = batched[0].shape[0]
            fov_dim = mesh.shape["fov"]
            if not oomlib.is_oom_error(e) or b // 2 < fov_dim or b % 2:
                raise
            oomlib.log.warning(
                "device OOM at batch=%d, retrying as 2 x %d", b, b // 2)
            halves = []
            for half in range(2):
                sl = slice(half * (b // 2), (half + 1) * (b // 2))
                halves.extend(run_with_oom_backoff(
                    tuple(a[sl] for a in batched)))
            return halves

    results = {}
    pending = []

    def flush():
        if not pending:
            return
        names = [n for n, _ in pending]
        stacks = [s for _, s in pending]
        n_pad = batch - len(stacks)
        stacks = stacks + [stacks[-1]] * n_pad
        batched = tuple(
            jnp.stack([s[li] for s in stacks])
            for li in range(len(stacks[0]))
        )
        outs = run_with_oom_backoff(batched)
        # chunks may be heterogeneous (one half can succeed at b/2 while the
        # other splits again under fragmentation-dependent OOM) — map global
        # row -> (chunk, local row) by consuming each chunk's actual size
        row_map = [(ci, oi) for ci, out in enumerate(outs)
                   for oi in range(out.n_cells.shape[0])]
        assert len(row_map) == batch, (len(row_map), batch)
        # One device->host transfer per chunk ARRAY (not per FOV slice):
        # each eager `out.x[oi]` + np.asarray would pay a device round trip,
        # 4x per FOV.
        host = [dict(n_cells=np.asarray(out.n_cells),
                     segmentation=np.asarray(out.segmentation),
                     avgint=np.asarray(out.avgint),
                     avgint_norm=np.asarray(out.avgint_norm),
                     code_idx=np.asarray(out.code_idx)) for out in outs]
        for bi, name in enumerate(names):
            ci, oi = row_map[bi]
            out = host[ci]
            n = int(out["n_cells"][oi])
            seg = out["segmentation"][oi]
            avgint = out["avgint"][oi][1:n + 1]
            norm = out["avgint_norm"][oi][1:n + 1]
            codes = [clf.codebook[int(c)]
                     for c in out["code_idx"][oi][1:n + 1]]
            prefix = os.path.join(out_dir, name)
            outputs.save_avgint_csv(prefix + "_avgint.csv", avgint)
            outputs.save_avgint_norm_csv_with_header(
                prefix + "_avgint_norm.csv", norm)
            np.save(prefix + "_seg.npy", seg)
            outputs.save_cell_ids(prefix + "_cell_ids.txt", codes)
            results[name] = (n, codes)
        pending.clear()

    for name, stack in FovPrefetcher(samples, depth=batch + 1):
        pending.append((name, tuple(jnp.asarray(a) for a in stack)))
        if len(pending) == batch:
            flush()
    flush()
    return results


def train_check_heads_dp(mesh, x, y, init_params, steps: int, lr: float):
    """Data-parallel check-head training step: batch sharded over 'fov',
    gradients psum-reduced across the mesh — the framework's 'full training
    step' under real data parallelism."""
    import optax
    from jax import shard_map
    from hiprfish_tpu.models.classifier import _mlp_logit

    tx = optax.adam(lr)

    def local_step(params, opt_state, xb, yb):
        def loss_fn(p):
            logit = _mlp_logit(p, xb)
            return jnp.mean(
                optax.sigmoid_binary_cross_entropy(logit, yb))

        g = jax.grad(loss_fn)(params)
        g = jax.lax.pmean(g, "fov")
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    sharded_step = shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(), P("fov"), P("fov")),
        out_specs=(P(), P()),
    )

    @jax.jit
    def train(params, x, y):
        opt_state = tx.init(params)

        def body(carry, _):
            p, s = carry
            p, s = sharded_step(p, s, x, y)
            return (p, s), None

        (params_out, _), _ = jax.lax.scan(body, (params, opt_state), None,
                                          length=steps)
        return params_out

    return train(init_params, jnp.asarray(x), jnp.asarray(y))
