"""Roofline accounting: the peaks table and the per-step normalization."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arcle_tpu.benchmarks import roofline

H100 = "NVIDIA H100 80GB HBM3"


def test_device_peaks_known_kinds():
    dev = types.SimpleNamespace(device_kind=H100, platform="gpu")
    p = roofline.device_peaks(dev)
    assert p["hbm_gbps"] > 0 and p["bf16_tflops"] > 0
    assert p["kind"] == H100 and p["source"]


def test_h100_peaks_row():
    """The data-sheet numbers of the SXM part (dense bf16, HBM3)."""
    p = roofline.PEAKS[H100]
    assert p["bf16_tflops"] == 989.0
    assert p["hbm_gbps"] == 3350.0
    assert "data sheet" in p["source"]


@pytest.mark.parametrize(
    "kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_raises(kind):
    dev = types.SimpleNamespace(device_kind=kind, platform="x")
    with pytest.raises(KeyError):
        roofline.device_peaks(dev)
    with pytest.raises(KeyError):
        roofline.summarize(1e6, batch=10, steps=10, cost=None, kind=kind)


def test_cost_from_compiled_counts_flops_and_bytes():
    def f(x):
        return (x @ x).sum()

    x = jnp.ones((128, 128), jnp.float32)
    compiled = jax.jit(f).lower(x).compile()
    cost = roofline.cost_from_compiled(compiled)
    assert cost is not None
    # one 128^3 matmul = 2*128^3 flops (XLA counts multiply-adds as 2)
    assert cost["flops"] >= 2 * 128 ** 3 * 0.9
    assert cost["bytes"] >= 128 * 128 * 4


def test_summarize_normalizes_per_step():
    cost = {"flops": 1e9, "bytes": 2e9}
    out = roofline.summarize(1e8, batch=1000, steps=100, cost=cost,
                             kind=H100, card="NVIDIA H100 80GB HBM3, 700 W")
    # 2e9 bytes / 1e5 env-steps = 2e4 B/step; at 1e8 steps/s = 2 TB/s
    assert out["xla_bytes_per_env_step"] == 2e4
    np.testing.assert_allclose(
        out["hbm_util_pct"], 100 * 2e12 / (3350.0 * 1e9), rtol=1e-3)
    assert out["card"].endswith("700 W")
