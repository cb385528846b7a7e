#!/usr/bin/env python
"""Profile the headline rollout (bench.py's O2ARCv2 cell, 4,096 envs x 100
steps) on one GPU and reduce the trace to where the device time goes.

Warms the compiled rollout, traces ``--runs`` rollouts with
``jax.profiler``, then sums the device events of the GPU planes:

* busy time (union of kernel intervals) and the idle share of the window;
* time per named scope of ``BatchedEnv.step`` and the rollout
  (``transition``, ``flood_fixup``, ``reward``, ``auto_reset``,
  ``actions``), matching each kernel to the scope path XLA records for it
  in the compiled program's metadata;
* the longest kernels by total time.

Writes the summary as JSON to ``--out`` and prints it.

Usage: python scripts/trace_headline.py [--batch 4096] [--steps 100]
       [--runs 3] [--out chiprun_out/trace_headline.json]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402

import bench  # noqa: E402
from arcle_tpu.benchmarks import roofline  # noqa: E402
from arcle_tpu.envs.core import reset_jit  # noqa: E402
from arcle_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

SCOPES = ("transition", "flood_fixup", "reward", "auto_reset", "actions")


def scope_of_instructions(hlo_text: str) -> dict:
    """HLO instruction name -> the first named scope in its op_name
    metadata (or "other").  Names are given as GPU kernels carry them
    (``fusion.12`` -> ``fusion_12``)."""
    out = {}
    pat = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = .*?op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        path = m.group(2).split("/")
        out[m.group(1).replace(".", "_").replace("-", "_")] = next(
            (s for s in path if s in SCOPES), "other")
    return out


def union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str, scopes: dict) -> dict:
    """Per-plane busy/idle, per-scope and per-kernel device time."""
    pd = jax.profiler.ProfileData.from_file(path)
    per_kernel = collections.Counter()
    per_scope = collections.Counter()
    planes = {}
    sample_stats = None
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        intervals = []
        for line in plane.lines:
            for ev in line.events:
                s = int(ev.start_ns)
                e = s + int(ev.duration_ns)
                intervals.append((s, e))
                per_kernel[ev.name] += int(ev.duration_ns)
                stats = dict(ev.stats)
                if sample_stats is None:
                    sample_stats = {k: str(v)[:120] for k, v in stats.items()}
                # kernels launched from a CUDA graph carry the graph as
                # hlo_op; the kernel's own name is the fusion's
                per_scope[scopes.get(ev.name, "unattributed")] += \
                    int(ev.duration_ns)
        if intervals:
            lo = min(s for s, _ in intervals)
            hi = max(e for _, e in intervals)
            busy = union_ns(intervals)
            planes[plane.name] = {
                "window_ms": (hi - lo) / 1e6, "busy_ms": busy / 1e6,
                "idle_share": 1.0 - busy / max(hi - lo, 1),
                "events": len(intervals),
                "lines": [ln.name for ln in plane.lines]}
    total = sum(per_kernel.values())
    return {
        "planes": planes,
        "kernel_time_ms": total / 1e6,
        "scope_share": {k: v / max(total, 1)
                        for k, v in per_scope.most_common()},
        "top_kernels_ms": [(k, v / 1e6)
                           for k, v in per_kernel.most_common(25)],
        "sample_event_stats": sample_stats,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/trace_headline.json")
    args = ap.parse_args()

    enable_compile_cache()
    dev = bench.require_gpu()
    env = bench.headline_env()
    key = jax.random.key(0)
    bs = reset_jit(env, key, args.batch)
    rj = jax.jit(bench.random_rollout, static_argnums=(3, 4))
    compiled = rj.lower(env, bs, key, args.steps, False).compile()
    bs, key, _ = jax.block_until_ready(compiled(env, bs, key))
    t0 = time.perf_counter()
    bs, key, _ = jax.block_until_ready(compiled(env, bs, key))
    untraced_ms = (time.perf_counter() - t0) * 1e3

    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            for _ in range(args.runs):
                bs, key, _ = jax.block_until_ready(compiled(env, bs, key))
        path = glob.glob(os.path.join(td, "**", "*.xplane.pb"),
                         recursive=True)[0]
        summary = reduce_trace(path, scope_of_instructions(
            compiled.as_text()))
    summary.update(
        card=roofline.card_name_and_power_limit(),
        device_kind=dev.device_kind, batch=args.batch, steps=args.steps,
        runs=args.runs, untraced_rollout_ms=untraced_ms,
        step_ms_from_trace=summary["kernel_time_ms"]
        / (args.runs * args.steps))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(summary, fp, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
