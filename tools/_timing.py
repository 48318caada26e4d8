"""Device timing for the profiling tools: queue N identical executions
(the device runs them in order), wait for the last with
``jax.block_until_ready``, divide by N."""

from __future__ import annotations

import time

import numpy as np


def device_time_ms(fn, *args, n: int = 8, reps: int = 3,
                   warmup: int = 1):
    """Median per-execution time of fn(*args) in ms over ``reps`` readings
    of ``n`` queued executions. Returns (ms, last_output)."""
    import jax

    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(n)]
        out = jax.block_until_ready(outs)[-1]
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1000 / n, out
