"""chip_smoke.py: its refusal to run without a GPU, and each of its phase
functions at tiny sizes on the CPU backend."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from arcle_tpu.benchmarks.answer_given import answer_given_env  # noqa: E402


def _run(argv, cwd, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script, tmp_path):
    out = _run([os.path.join(ROOT, script)], ROOT, tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_without_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("family", ["o2arc", "arc", "raw"])
def test_oracle_parity_tiny(family):
    out = chip_smoke.oracle_parity(family, n_envs=3, n_steps=20,
                                   episode_limit=6)
    assert out["episodes_reset"] > 0          # auto-reset path exercised
    assert out["field_compares"] >= 3 * 20 * 9


@pytest.mark.parametrize("which", ["o2arc", "answer_given"])
def test_devices_agree_tiny(which):
    env = (bench.headline_env() if which == "o2arc"
           else answer_given_env(n_tasks=64))
    cpu = jax.devices("cpu")
    out = chip_smoke.devices_agree(env, 4, 4, cpu[0], cpu[1])
    assert out["elements"] > 0


def test_assert_bit_equal_catches_one_bit():
    import numpy as np
    a = {"x": np.zeros(4, np.float32)}
    b = {"x": np.array([0, 0, -0.0, 0], np.float32)}   # sign bit only
    with pytest.raises(AssertionError):
        chip_smoke.assert_bit_equal(a, b, "t")


def test_trainer_one_iteration_tiny():
    cfg = chip_smoke.trainer_config(n_envs=8, hidden=(16,), episode_limit=4,
                                    iterations=1, n_synthetic_tasks=4)
    out = chip_smoke.trainer(cfg)
    assert len(out["losses"]) == 1
    assert out["checkpoint_step"] == 0


def test_mlp_deviation_tiny():
    out = chip_smoke.mlp_deviation(n_envs=8, hidden=(32, 16))
    assert out["highest"] < 1e-5 and out["default"] < 1e-5   # f32 on CPU


def test_dp_ppo_four_virtual_devices_match_one():
    """The --four phase on 4 of the CPU backend's virtual devices."""
    devices = jax.devices("cpu")
    assert len(devices) >= 4, "tests/conftest.py provides 8 CPU devices"
    out = chip_smoke.dp_ppo(devices[:4], envs_per_device=2, iterations=2,
                            hidden=(16,), episode_limit=4,
                            n_synthetic_tasks=4)
    assert out["devices"] == 4 and out["carry_elements"] > 0


@pytest.mark.gpu
def test_gpu_rollout_matches_cpu(gpu_device):
    out = chip_smoke.devices_agree(bench.headline_env(), 256, 20,
                                   gpu_device, jax.devices("cpu")[0])
    assert out["elements"] > 0
