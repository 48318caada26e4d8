"""Multi-host execution.

The reference's only scale-out axis is Snakemake launching one OS process
per FOV on a cluster (ecoli/Snakefile:63-114). The design here has two
levels:

  * across hosts: FOVs are embarrassingly parallel — the sample list is
    sharded by process index, each host runs the batched pipeline on its
    own devices, artifacts land on the shared filesystem exactly as the
    reference's per-rule outputs do. No collectives cross hosts on the
    inference path.
  * within a host: the ('fov', 'tile') mesh from parallel/mesh.py —
    batched FOV data parallelism plus shard_map halo exchange
    (parallel/spatial.py).
  * training: fov_batch.train_check_heads_dp is mesh-agnostic — given a
    global (multi-process) mesh its lax.pmean gradient reduction lowers to
    collectives over the devices' interconnect within a host and the
    network across hosts; XLA picks the transport.

initialize_from_env() wires jax.distributed: set
HIPRFISH_COORDINATOR=host:port, HIPRFISH_NUM_PROCESSES and
HIPRFISH_PROCESS_ID (e.g. from SLURM_PROCID); without them the run is
single-process.
"""

from __future__ import annotations

import os


def initialize_from_env() -> bool:
    """Initialize jax.distributed from environment variables. Returns True
    when a multi-process runtime was initialized, False for single-process
    (no coordinator configured)."""
    import jax

    coord = os.environ.get("HIPRFISH_COORDINATOR")
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["HIPRFISH_NUM_PROCESSES"]),
            process_id=int(os.environ["HIPRFISH_PROCESS_ID"]),
        )
        return True
    return False


def host_shard(samples):
    """This process's share of the global FOV list (round-robin by process
    index — the multi-host replacement for Snakemake's per-FOV job fan-out)."""
    import jax

    return list(samples)[jax.process_index()::jax.process_count()]


def global_mesh(fov: int | None = None, tile: int = 1):
    """('fov', 'tile') mesh over ALL processes' devices (jax.devices() is
    global after jax.distributed.initialize)."""
    from hiprfish_tpu.parallel.mesh import make_mesh

    return make_mesh(fov=fov, tile=tile)


def local_mesh(tile: int = 1):
    """('fov', 'tile') mesh over this process's addressable devices only —
    the right mesh for the inference path, where cross-host parallelism is
    the sample-list shard, not a collective."""
    import numpy as np
    import jax
    from jax.sharding import Mesh

    devices = jax.local_devices()
    fov = max(1, len(devices) // tile)
    grid = np.asarray(devices[: fov * tile]).reshape(fov, tile)
    return Mesh(grid, ("fov", "tile"))


def run_distributed_pipeline(samples, clf, cfg=None, max_cells: int = 4096,
                             out_dir: str = ".", tile: int = 1,
                             denoise: bool = True):
    """Multi-host batch runner: initialize the runtime (if configured),
    take this host's shard of the sample list, and run the batched fused
    pipeline over the local chip mesh. Artifacts are written to the shared
    out_dir under the reference's filename contract; every host returns its
    own {sample: (n_cells, codes)} map."""
    from hiprfish_tpu.parallel import fov_batch

    initialize_from_env()
    local = host_shard(samples)
    if not local:
        return {}
    return fov_batch.run_batch_pipeline(
        local, clf, cfg=cfg, max_cells=max_cells, mesh=local_mesh(tile),
        denoise=denoise, out_dir=out_dir)
