"""Benchmark suites reproducing the reference's published experiments.

The reference repo ships no benchmark code; its published numbers live in
the CoLLAs 2024 paper (/root/reference/arcle_paper.pdf §4.1) and are the
headline baselines recorded in BASELINE.md.  This package implements those
experiment setups on the batched engine so the framework can be measured
against the paper's results directly.
"""

from .answer_given import (  # noqa: F401
    AnswerGivenConfig,
    RandomPairLoader,
    answer_given_agent,
    answer_given_env,
    answer_obs,
    color_table,
    make_policy,
    small_arc_loader,
)
