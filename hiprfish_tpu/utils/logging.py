"""Structured logging + per-stage timing (the observability subsystem the
reference lacks — SURVEY.md §5: progress was print()-only).

Events are JSON lines (timestamp, stage, sample, seconds, extra) to stderr
and optionally a file; StageTimer wraps pipeline stages and accumulates a
per-run summary (FOVs/s, megapixels/s)."""

from __future__ import annotations

import contextlib
import json
import sys
import time


class RunLog:
    def __init__(self, path: str | None = None, stream=None):
        self.path = path
        self.stream = stream if stream is not None else sys.stderr
        self.events = []

    def event(self, stage: str, **kwargs):
        rec = {"t": round(time.time(), 3), "stage": stage, **kwargs}
        self.events.append(rec)
        line = json.dumps(rec)
        print(line, file=self.stream)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")

    @contextlib.contextmanager
    def stage(self, name: str, **kwargs):
        t0 = time.time()
        try:
            yield
        finally:
            self.event(name, seconds=round(time.time() - t0, 3), **kwargs)

    def summary(self):
        totals = {}
        for e in self.events:
            if "seconds" in e:
                totals.setdefault(e["stage"], [0.0, 0])
                totals[e["stage"]][0] += e["seconds"]
                totals[e["stage"]][1] += 1
        return {
            k: {"total_s": round(v[0], 3), "count": v[1]}
            for k, v in totals.items()
        }


def profile_trace(logdir: str):
    """jax.profiler trace context for device timeline capture."""
    import jax

    return jax.profiler.trace(logdir)
