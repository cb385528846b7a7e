"""Metrics / logging / profiling hooks.

The reference logs through wandb with a fixed schema (train.py:130-150)
and has no in-env timers (SURVEY.md §5).  Here: a dependency-free metric
logger (JSONL + stdout) with the same metric names, steps/s accounting
that waits for the device, and jax.profiler trace helpers."""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Dict, Optional

import jax
import numpy as np


class MetricLogger:
    """wandb-schema-compatible metric sink (train.py:130-150 keys), writing
    JSONL; plug a wandb run in via ``backend`` if available."""

    def __init__(self, path: Optional[str] = None, backend=None):
        self.path = path
        self.backend = backend
        self._fp = open(path, "a") if path else None
        self.t0 = time.time()

    def meta(self, info: Dict) -> None:
        """Write a one-line provenance header (run config, seed, git sha)
        so the JSONL record is interpretable on its own — the record
        line is tagged ``{"meta": ...}`` and carries no ``iteration``
        key, so curve readers that filter on ``iteration`` skip it."""
        if self._fp:
            self._fp.write(json.dumps({"meta": info,
                                       "ts": time.time()}) + "\n")
            self._fp.flush()

    def log(self, step: int, metrics: Dict) -> None:
        clean = {}
        for k, v in metrics.items():
            if hasattr(v, "shape"):
                v = np.asarray(v)
                v = v.item() if v.ndim == 0 else v.tolist()
            clean[k] = v
        clean["iteration"] = step
        clean["wall_time"] = time.time() - self.t0
        if self._fp:
            self._fp.write(json.dumps(clean) + "\n")
            self._fp.flush()
        if self.backend is not None:
            self.backend.log(clean, step=step)
        else:
            brief = {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in clean.items() if not isinstance(v, list)}
            print(f"[{step}] {brief}", file=sys.stderr, flush=True)


class Throughput:
    """env-steps/s between ticks, with ``jax.block_until_ready`` on the
    step's outputs as the completion barrier."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._last = time.perf_counter()

    def tick(self, n_env_steps: int, outputs=None) -> float:
        """Instantaneous rate over the window since the previous tick
        (the first window includes compilation)."""
        if outputs is not None:
            jax.block_until_ready(outputs)
        now = time.perf_counter()
        rate = n_env_steps / max(now - self._last, 1e-9)
        self._last = now
        return rate


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace context (SURVEY.md §5 tracing disposition)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
