import pytest
"""Aux subsystems: config, checkpointing, metrics, render."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp

from arcle_tpu.utils.config import RunConfig, EnvConfig, make_table, \
    make_loader
from arcle_tpu.utils.metrics import MetricLogger, Throughput
from arcle_tpu.utils.checkpoint import Checkpointer


def test_config_json_roundtrip():
    cfg = RunConfig(env=EnvConfig(family="raw"))
    js = json.loads(cfg.to_json())
    assert js["env"]["family"] == "raw"
    assert make_table(cfg.env).n_ops == 12
    assert len(make_loader(cfg.env).data) > 0


def test_metric_logger(tmp_path):
    path = str(tmp_path / "m.jsonl")
    lg = MetricLogger(path)
    lg.log(0, {"loss": jnp.asarray(1.5), "vec": jnp.asarray([1.0, 2.0])})
    row = json.loads(open(path).read().strip())
    assert row["loss"] == 1.5 and row["vec"] == [1.0, 2.0]
    t = Throughput()
    rate = t.tick(100, jnp.asarray(0.0))
    assert rate > 0


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    tree = {"params": {"w": jnp.arange(6.0).reshape(2, 3)},
            "step": jnp.asarray(3)}
    ck.save(0, tree)
    assert ck.latest_step() == 0
    template = jax.tree.map(np.zeros_like, tree)
    restored = ck.restore(template)
    np.testing.assert_array_equal(np.asarray(restored["params"]["w"]),
                                  np.asarray(tree["params"]["w"]))


def test_checkpoint_rejects_other_tree(tmp_path):
    """Restoring into a template of another structure or shape raises
    instead of mis-assigning leaves; only the newest steps are kept."""
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    tree = {"a": np.ones(3, np.float32), "b": jnp.asarray(2, jnp.int32)}
    for step in range(4):
        ck.save(step, tree)
    assert ck.steps() == [2, 3]
    with pytest.raises(ValueError):
        ck.restore({"a": np.ones(3, np.float32), "c": 0})
    with pytest.raises(ValueError):
        ck.restore({"a": np.ones(4, np.float32), "b": 0})
    assert ck.restore(tree, step=2)["b"] == 2


@pytest.mark.parametrize("preset", [None, "given"])
def test_compile_cache_placement(preset, tmp_path, monkeypatch):
    """A set JAX_COMPILATION_CACHE_DIR wins and nothing is set in code;
    unset, the cache is the checkout's fixed .jax_cache."""
    from arcle_tpu.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    if preset is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        want = os.path.join(compile_cache.REPO_ROOT, ".jax_cache")
        assert compile_cache.default_cache_dir({}) == want
    else:
        want = str(tmp_path / "given")
        monkeypatch.setenv(compile_cache.ENV_VAR, want)
        assert compile_cache.default_cache_dir(os.environ) is None
    try:
        assert compile_cache.enable_compile_cache() == want
        if preset is None:
            assert jax.config.jax_compilation_cache_dir == want
        else:
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.slow
def test_train_driver_smoke(tmp_path):
    """python -m arcle_tpu.training.train --smoke runs a PPO iteration."""
    from arcle_tpu.training.train import main
    main(["--smoke", "--algo", "ppo", "--iterations", "1",
          "--log-file", str(tmp_path / "log.jsonl"),
          "--ckpt-dir", str(tmp_path / "ck")])
    assert os.path.exists(tmp_path / "log.jsonl")


@pytest.mark.slow
def test_train_gpt_driver_smoke(tmp_path):
    from arcle_tpu.training.train_gpt import main
    main(["--smoke", "--algo", "ppo", "--iterations", "1",
          "--log-file", str(tmp_path / "log.jsonl"),
          "--ckpt-dir", str(tmp_path / "ck")])
    assert os.path.exists(tmp_path / "log.jsonl")


@pytest.mark.slow
def test_train_driver_resume(tmp_path):
    """Kill-and-resume: the restored run continues from the checkpointed
    iteration (the RLlib algo.save / from_checkpoint counterpart)."""
    from arcle_tpu.training.train import main
    log = str(tmp_path / "log.jsonl")
    main(["--smoke", "--algo", "ppo", "--iterations", "2",
          "--log-file", log, "--ckpt-dir", str(tmp_path / "ck")])
    main(["--smoke", "--algo", "ppo", "--iterations", "4", "--resume",
          "--log-file", log, "--ckpt-dir", str(tmp_path / "ck")])
    rows = [json.loads(l) for l in open(log) if l.strip()]
    its = [r["iteration"] for r in rows]
    # first run logs 0,1; the resumed run starts at 2 (not 0) and reaches 3
    assert its == [0, 1, 2, 3]


@pytest.mark.slow
def test_emaml_driver_smoke_bookkeeping(tmp_path):
    """E-MAML driver logs the reference wandb schema incl. success
    counters (train.py:130-150), and resume restores the counters."""
    from arcle_tpu.training.train import main
    log = str(tmp_path / "log.jsonl")
    main(["--smoke", "--algo", "emaml", "--iterations", "1",
          "--log-file", log, "--ckpt-dir", str(tmp_path / "ck")])
    row = json.loads(open(log).read().strip().splitlines()[-1])
    for k in ("outer_policy_loss", "outer_vf_loss", "outer_total_loss",
              "adapt_eprewmean", "post_eprewmean", "post_eprewmax",
              "num_covered_tasks", "num_succeed_tasks"):
        assert k in row, k
    assert row["num_covered_tasks"] >= 1
    main(["--smoke", "--algo", "emaml", "--iterations", "2", "--resume",
          "--log-file", log, "--ckpt-dir", str(tmp_path / "ck")])
    rows = [json.loads(l) for l in open(log) if l.strip()]
    assert rows[-1]["iteration"] == 1
    # coverage accumulates across the resume
    assert rows[-1]["num_covered_tasks"] >= rows[0]["num_covered_tasks"]


def test_supervise_restarts_on_crash_and_hang(tmp_path):
    """supervise.py relaunches a crashed child with --resume and kills a
    hung one on log staleness (the single-host failure-detection story
    for flaky device runtimes)."""
    import sys
    from arcle_tpu.training.supervise import run_supervised

    log = tmp_path / "run.log"
    marker = tmp_path / "attempts"
    # child: appends a line per launch; crashes unless --resume present
    prog = (
        "import sys, time, pathlib\n"
        f"m = pathlib.Path({str(marker)!r})\n"
        "m.write_text(m.read_text() + 'x' if m.exists() else 'x')\n"
        "print('hello', flush=True)\n"
        "sys.exit(0 if '--resume' in sys.argv else 3)\n")
    marker.write_text("")
    rc = run_supervised([sys.executable, "-c", prog], str(log),
                        stale=60.0, max_restarts=2, poll=0.2)
    assert rc == 0
    assert marker.read_text().count("x") == 2      # crash once, resume once
    assert b"--resume" in log.read_bytes()

    # hang: child sleeps forever without writing -> staleness kill
    hang = ("import sys, time\n"
            "if '--resume' in sys.argv: sys.exit(0)\n"
            "print('started', flush=True)\n"
            "time.sleep(600)\n")
    log2 = tmp_path / "run2.log"
    rc = run_supervised([sys.executable, "-c", hang], str(log2),
                        stale=1.5, max_restarts=2, poll=0.3)
    assert rc == 0
    assert b"killing process group" in log2.read_bytes()


@pytest.mark.slow
def test_ppo_chunked_driver_matches_fused(tmp_path):
    """ppo_chunked=True (two jitted units: rollout | update — the
    large-model path) must log the same curve as the fused
    single-program iteration."""
    import json
    import subprocess
    import sys

    def run(chunked):
        log = tmp_path / f"log_{chunked}.jsonl"
        code = (
            "import sys, dataclasses\n"
            "from arcle_tpu.training.train import run_ppo\n"
            "from arcle_tpu.utils.config import RunConfig, EnvConfig\n"
            "from arcle_tpu.training.ppo import PPOConfig\n"
            "from arcle_tpu.utils.metrics import MetricLogger\n"
            "cfg = RunConfig(seed=3, algo='ppo', total_iterations=3,\n"
            "    checkpoint_every=0, checkpoint_dir=sys.argv[2],\n"
            "    env=EnvConfig(family='o2arc_crop33', max_trial=7,\n"
            "                  episode_limit=8, n_envs=16,\n"
            "                  dataset='synthetic', n_synthetic_tasks=6),\n"
            "    ppo=PPOConfig(n_epochs=1, n_minibatches=2),\n"
            "    mlp_hidden=(32,), ppo_chunked=%r)\n"
            "run_ppo(cfg, MetricLogger(sys.argv[1]))\n" % chunked)
        subprocess.run(
            [sys.executable, "-c", code, str(log),
             str(tmp_path / f"ck_{chunked}")],
            check=True, cwd="/root/repo",
            env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "",
                 "JAX_PLATFORMS": "cpu", "HOME": "/root"})
        return [json.loads(l) for l in open(log)]

    fused, chunked = run(False), run(True)
    assert len(fused) == len(chunked) == 3
    for a, b in zip(fused, chunked):
        assert abs(a["total_loss"] - b["total_loss"]) < 1e-5 * max(
            1.0, abs(a["total_loss"])), (a, b)
        assert a["success_rate"] == b["success_rate"]
