#!/usr/bin/env python
"""Summarize a GPT E-MAML run record (the JSONL log of
``python -m arcle_tpu.training.train_gpt``): iteration count, wall-clock,
and the post-adaptation reward trend (rising post-adaptation reward /
solves).

Usage: python scripts/summarize_emaml.py <run log.jsonl>
"""

import json
import sys

import numpy as np


def main(path):
    rows = []
    for line in open(path):
        d = json.loads(line)
        if "meta" in d or d.get("_meta"):
            continue
        rows.append(d)
    if not rows:
        print("no iterations")
        return
    n = len(rows)
    post = np.array([r["post_eprewmean"] for r in rows], float)
    adapt = np.array([r["adapt_eprewmean"] for r in rows], float)
    vf = np.array([r["outer_vf_loss"] for r in rows], float)
    succ = max(r.get("num_succeed_tasks", 0) for r in rows)
    wall = rows[-1]["wall_time"] - rows[0]["wall_time"]
    s_iter = wall / max(n - 1, 1)

    def mean(a):
        return float(np.mean(a)) if len(a) else float("nan")

    k = max(n // 5, 1)
    first_k, last_k = post[:k], post[-k:]
    # least-squares slope of post reward per iteration
    x = np.arange(n)
    slope = float(np.polyfit(x, post, 1)[0]) if n > 2 else float("nan")
    print(f"iterations: {n}   wall: {wall / 3600:.2f} h "
          f"({s_iter:.1f} s/iter)")
    print(f"post-adaptation eprew: first-{k} mean {mean(first_k):+.3f}  "
          f"last-{k} mean {mean(last_k):+.3f}  "
          f"delta {mean(last_k) - mean(first_k):+.3f}  "
          f"slope {slope:+.4f}/iter")
    print(f"adapt eprew (per-step): first-{k} {mean(adapt[:k]):+.4f}  "
          f"last-{k} {mean(adapt[-k:]):+.4f}")
    print(f"outer vf loss: first-{k} {mean(vf[:k]):.3f}  "
          f"last-{k} {mean(vf[-k:]):.3f}")
    print(f"num_succeed_tasks (max over run): {succ}")
    ut = rows[-1].get("unit_times")
    if ut:
        tot = sum(v["s"] for v in ut.values())
        top = sorted(ut.items(), key=lambda kv: -kv[1]["s"])[:3]
        print("last-iter unit times: " + ", ".join(
            f"{k2}={v['s']:.1f}s/n={v['n']}" for k2, v in top)
            + f" (total {tot:.1f}s)")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
