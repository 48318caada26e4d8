"""Prefetching FOV loader: overlap host-side image decode with device compute.

The reference's Snakemake design re-opens a JVM per FOV process; here a
thread pool decodes the next FOVs' per-laser planes (CZI via the native C++
decoder, or npy) and optionally stages them onto the device while the current
FOV computes — so the device never waits on ingest.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

from hiprfish_tpu.io import images as iio


class FovPrefetcher:
    """Iterate (key, stack) over FOVs with background decode.

    Args:
      fovs: sequence of (key, [per-laser filenames]).
      depth: number of FOVs decoded ahead.
      device_put: stage arrays onto the default device in the worker thread.
    """

    def __init__(self, fovs: Sequence, depth: int = 2, workers: int = 4,
                 device_put: bool = False):
        self.fovs = list(fovs)
        self.depth = depth
        self.device_put = device_put
        self.pool = ThreadPoolExecutor(max_workers=workers)

    def _load(self, item):
        key, filenames = item
        stack = iio.load_image_stack(filenames)
        if self.device_put:
            import jax

            stack = [jax.device_put(a) for a in stack]
        return key, stack

    def __iter__(self):
        pending = []
        idx = 0
        while idx < len(self.fovs) or pending:
            while idx < len(self.fovs) and len(pending) < self.depth:
                pending.append(self.pool.submit(self._load, self.fovs[idx]))
                idx += 1
            fut = pending.pop(0)
            yield fut.result()

    def close(self):
        self.pool.shutdown(wait=False)
