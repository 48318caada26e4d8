"""Out-of-memory recovery: automatic chunk/batch backoff.

The reference survives large inputs by looping small numpy tiles
(biofilm_analysis.py:1105-1126), so it degrades gracefully by construction.
The device engines instead compile whole-volume programs parameterized by a
static chunk or batch size — a size that overflows device memory surfaces
as one ``RESOURCE_EXHAUSTED`` XlaRuntimeError. This module is the
recovery analogue: retry the jitted program down a ladder of smaller static
sizes, recording what happened for observability.

Used by the chunked 3D pipeline (pipeline/segment3d.py) and the DP FOV
batch runner (parallel/fov_batch.py); any staged computation with a
size-like static argument can opt in.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Sequence

log = logging.getLogger("hiprfish_tpu.oom")


def is_oom_error(e: Exception) -> bool:
    """True for XLA device out-of-memory failures: dispatch-time and
    compile-time ``RESOURCE_EXHAUSTED`` ("Out of memory while trying to
    allocate ..." on the GPU)."""
    s = str(e)
    return ("RESOURCE_EXHAUSTED" in s or "ResourceExhausted" in s
            or "out of memory" in s.lower())


def run_with_backoff(fn: Callable, sizes: Sequence,
                     label: str = "chunk", on_retry: Callable | None = None):
    """``fn(size)`` down a ladder of sizes until one fits on device.

    Returns (result, size_used). Non-OOM exceptions propagate immediately;
    exhausting the ladder re-raises the last OOM. ``on_retry(size, next)``
    is called before each retry (hook for freeing caches/arrays)."""
    sizes = list(sizes)
    if not sizes:
        raise ValueError("empty size ladder")
    last = None
    for i, size in enumerate(sizes):
        try:
            return fn(size), size
        except Exception as e:  # noqa: BLE001 - filtered by is_oom_error
            if not is_oom_error(e):
                raise
            last = e
            nxt = sizes[i + 1] if i + 1 < len(sizes) else None
            log.warning("device OOM at %s=%s%s", label, size,
                        f", retrying with {nxt}" if nxt is not None
                        else "; ladder exhausted")
            if nxt is not None and on_retry is not None:
                on_retry(size, nxt)
    raise last


def halving_ladder(start: int, floor: int = 1) -> Iterable[int]:
    """start, start//2, ... down to ``floor`` (inclusive when reached)."""
    out = []
    s = int(start)
    while s > floor:
        out.append(s)
        s //= 2
    out.append(max(s, floor))
    return out
