#!/usr/bin/env python
"""BASELINE config-3 batch sweep: the ARC-27 + PointWrapper engine at
1024/2048/4096 envs on one GPU.  Prints one JSON line.

Usage: python scripts/sweep_config3.py
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from bench import bench_engine, log, require_gpu  # noqa: E402
from arcle_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def main():
    enable_compile_cache()
    require_gpu()

    from arcle_tpu.loaders.synthetic import write_corpus
    from arcle_tpu.loaders import ARCLoader
    from arcle_tpu.ops import arc_table

    with tempfile.TemporaryDirectory() as td:
        write_corpus(td, n_tasks=400, n_train=6, n_test=2)
        bank = ARCLoader(root=td).bank()

    out = {}
    for b in (1024, 2048, 4096):
        rate = bench_engine(b, 100, 2, table=arc_table(max_trial=-1),
                         bank=bank, point_actions=True)
        out[f"arc_point_{b}env"] = round(rate)
        log(f"config3 B={b}: {rate:,.0f} steps/s")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
