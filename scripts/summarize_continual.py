"""Summarize the §4.1.2 continual-setting runs into the paper's Fig-7
shape: per-phase success trajectories for the sequential vs
color-equivariant arms.

Usage:
    python scripts/summarize_continual.py <run log.jsonl> [...]

Each log is one ``train_answer_given --continual`` run (one arm).
"""

from __future__ import annotations

import json
import sys


def load(path):
    rows = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("_meta") or "_meta" in str(r.get("config", ""))[:0]:
                continue
            if "success_rate" in r:
                rows.append(r)
    return rows


def phase_stats(rows, phase_iters=400, n_phases=5):
    """Per phase: peak and final-quarter-mean success."""
    out = []
    for p in range(n_phases):
        pr = [r for r in rows
              if p * phase_iters <= r["iteration"] < (p + 1) * phase_iters]
        if not pr:
            out.append(None)
            continue
        peak = max(r["success_rate"] for r in pr)
        tail = [r["success_rate"] for r in pr
                if r["iteration"] >= (p + 1) * phase_iters - phase_iters // 4]
        rec = next((r["iteration"] - p * phase_iters for r in pr
                    if r["success_rate"] >= 0.5), None)
        out.append({"phase": p, "colors": 2 * (p + 1),
                    "iters": len(pr),
                    "peak": peak,
                    "recover_iters": rec,
                    "final_quarter_mean": (sum(tail) / len(tail)
                                           if tail else float("nan"))})
    return out


def main(argv):
    if len(argv) < 2:
        sys.exit(__doc__)
    for path in argv[1:]:
        rows = load(path)
        print(f"\n== {path} ({len(rows)} iterations)")
        print(f"{'phase':>5} {'colors':>6} {'peak':>7} {'final-1/4':>10} "
              f"{'iters-to-50%':>13}")
        for st in phase_stats(rows):
            if st is None:
                continue
            rec = (str(st["recover_iters"])
                   if st["recover_iters"] is not None else "-")
            print(f"{st['phase']:>5} {st['colors']:>6} "
                  f"{st['peak']:>7.3f} {st['final_quarter_mean']:>10.3f} "
                  f"{rec:>13}")


if __name__ == "__main__":
    main(sys.argv)
