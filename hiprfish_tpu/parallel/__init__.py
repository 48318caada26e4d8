"""Multi-chip scale-out: device meshes, FOV-batch data parallelism, and
spatially sharded kernels with halo exchange.

The reference's only scale-out axis is Snakemake process fan-out over FOVs
(ecoli/Snakefile:63-114). Here that becomes a sharded batch axis on a
jax.sharding.Mesh; oversized FOVs/volumes additionally shard spatially with
ppermute halo exchange between devices (the analogue of the reference's halo'd
tiling, biofilm_analysis.py:900-917).
"""
