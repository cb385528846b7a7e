#!/usr/bin/env python
"""Smoke run of the main path on one GPU, through the entry points a user
calls, at the sizes the repository's benchmark and trainer use.

Phases, in one process on one card:

0. Device: the card's name and power limit (``nvidia-smi``), the JAX
   version, the devices and the compile-cache directory.  Exits non-zero,
   printing no result, unless JAX's first device is a GPU.
1. Engine parity: ``BatchedEnv.step`` with random bbox actions and
   auto-reset against the NumPy oracle, 64 envs x 100 steps for each of the
   O2ARCv2, ARC-27 and Raw tables, bit-exact in every state field the
   oracle carries, the reward and the termination flags.  Then whole
   rollouts on the GPU against the same rollouts on JAX's CPU backend in
   this process, bit-equal: O2ARCv2 at 4,096 envs x 100 steps, and the
   5x5 answer-given env.
2. Headline rollout: ``bench.py``'s O2ARCv2 cell, 4,096 envs x 100 steps:
   compile time, ``memory_analysis()``, median and spread of env-steps/s.
3. Trainer: ``run_ppo`` with ``train.py``'s defaults (o2arc_crop33, dense
   reward, augmentation, 4,096 envs, T = 100, MLP [1024,1024,512,512,256,
   128]) for 3 iterations with checkpointing; the policy forward against a
   float64 NumPy reference at two matmul precisions.

``--four`` runs only the data-parallel trainer across four GPUs (envs
sharded over a flat ``data`` mesh, params replicated, gradients all-reduced
by XLA) and its comparison with the same global batch on one GPU.

The last line of stdout is ``{"ok": true, "device": {...}}``; any failed
check raises before it.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

import bench
from arcle_tpu.benchmarks.answer_given import answer_given_env
from arcle_tpu.envs import BatchedEnv
from arcle_tpu.envs.core import reset_jit
from arcle_tpu.loaders import SyntheticLoader
from arcle_tpu.models.mlp import FCPolicy, fc_policy_reference
from arcle_tpu.ops import arc_table, o2arc_table, raw_table
from arcle_tpu.oracle import OracleEnv
from arcle_tpu.oracle.oracle_env import FAMILY_FIELDS
from arcle_tpu.parallel import make_mesh, replicate, shard_leading
from arcle_tpu.training.ppo import make_optimizer
from arcle_tpu.training.rollout import decode_bbox_actions
from arcle_tpu.training.train import (
    build_agent, compose_iteration, make_ppo_env, ppo_iteration_parts,
    run_ppo,
)
from arcle_tpu.utils.checkpoint import Checkpointer
from arcle_tpu.utils.compile_cache import enable_compile_cache
from arcle_tpu.utils.config import EnvConfig, RunConfig
from arcle_tpu.utils.metrics import MetricLogger
from arcle_tpu.wrappers import flatten_obs

TABLES = {"o2arc": o2arc_table, "arc": arc_table, "raw": raw_table}
FULL_MLP = RunConfig().mlp_hidden
# Relative deviation allowed between the MLP forward and its float64 NumPy
# reference.  "highest": float32 throughout; rounding over sums of up to
# 2,710 terms and six layers stays near 1e-6, so 1e-4 leaves margin.
# "default": XLA may run float32 matmuls as TF32 on this card, which
# rounds operands to 10 mantissa bits (unit roundoff 4.9e-4); the output
# error stays within a few times that, well under 2e-2 of its scale.
MLP_TOL = {"highest": 1e-4, "default": 2e-2}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the cards."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def to_host(tree):
    """NumPy copy of a pytree; typed PRNG keys become their raw bits."""
    def leaf(x):
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            x = jax.random.key_data(x)
        return np.asarray(jax.device_get(x))
    return jax.tree.map(leaf, tree)


def assert_bit_equal(a, b, what: str) -> int:
    """Every leaf of the two host trees equal bit for bit; returns the
    number of elements compared."""
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    if ta != tb:
        raise AssertionError(f"{what}: tree structures differ")
    n = 0
    for (path, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape or \
                x.tobytes() != y.tobytes():
            diff = int(np.sum(x != y)) if x.shape == y.shape else -1
            raise AssertionError(
                f"{what}: leaf {jax.tree_util.keystr(path)} differs "
                f"({diff} elements)")
        n += x.size
    return n


# ---------------------------------------------------------------------------
# Phase 1: engine parity
# ---------------------------------------------------------------------------
def oracle_parity(family: str, n_envs: int = 64, n_steps: int = 100,
                  seed: int = 0, max_trial: int = 3,
                  episode_limit: int = 25) -> dict:
    """Step ``BatchedEnv`` (random bbox actions, auto-reset from the reset
    pool) and one NumPy oracle per env in lockstep; every oracle-carried
    state field, the reward, ``terminated`` and ``truncated`` must be equal
    after every step.  An env that ends an episode re-syncs its oracle to
    the task the engine reset it to."""
    table = TABLES[family](max_trial=max_trial)
    fields = FAMILY_FIELDS[family]
    env = BatchedEnv(table=table, bank=SyntheticLoader(16, seed=3).bank(),
                     max_trial=max_trial, episode_limit=episode_limit,
                     auto_reset=True, reset_pool=8)
    bs = env.reset(jax.random.key(seed), n_envs)
    step = jax.jit(lambda env, bs, a: env.step(bs, decode_bbox_actions(a)))
    orcs = [OracleEnv(family, max_trial=max_trial) for _ in range(n_envs)]

    def sync(i, st):
        h, w = st.input_dim[i]
        ah, aw = st.answer_dim[i]
        orcs[i].reset(st.input[i, :h, :w], st.answer[i, :ah, :aw])

    host = jax.device_get(bs.env)
    for i in range(n_envs):
        sync(i, host)
    rng = np.random.default_rng(seed)
    n_cmp = n_resets = 0
    for t in range(n_steps):
        c = rng.integers(0, 30, (4, n_envs))
        ops = rng.integers(0, table.n_ops, n_envs)
        acts = np.stack([c[0], c[1], c[2], c[3], ops], -1).astype(np.int32)
        bs, obs, rew, term, trunc = step(env, bs, jnp.asarray(acts))
        obs, rew, term, trunc, new = jax.device_get(
            (obs, rew, term, trunc, bs.env))
        for i in range(n_envs):
            x1, y1, x2, y2, op = (int(v) for v in acts[i])
            sel = np.zeros((30, 30), np.int8)
            sel[min(x1, x2):max(x1, x2) + 1, min(y1, y2):max(y1, y2) + 1] = 1
            ost, orew, oterm = orcs[i].step(sel, op)
            where = f"{family} env {i} step {t} op {op}"
            for name, get in fields:
                if not np.array_equal(getattr(obs, name)[i], get(ost)):
                    raise AssertionError(f"{where}: field {name} differs")
            checks = (("reward", float(rew[i]) == orew),
                      ("terminated", bool(term[i]) == oterm),
                      ("truncated",
                       bool(trunc[i]) == (ost["_steps"] >= episode_limit)))
            for name, ok in checks:
                if not ok:
                    raise AssertionError(f"{where}: {name} differs")
            n_cmp += len(fields) + len(checks)
            if term[i] or trunc[i]:
                sync(i, new)
                n_resets += 1
    return {"family": family, "envs": n_envs, "steps": n_steps,
            "field_compares": n_cmp, "episodes_reset": n_resets}


def rollout_on(device, env: BatchedEnv, batch: int, steps: int,
               seed: int = 0):
    """bench.py's random-action rollout with every input on ``device``;
    returns the host copy of (final carry, per-step rewards)."""
    with jax.default_device(device):
        env = jax.device_put(env, device)
        key = jax.random.key(seed)
        bs = reset_jit(env, key, batch)
        bs, _, rews = jax.jit(bench.random_rollout, static_argnums=3)(
            env, bs, key, steps)
        return to_host((bs, rews))


def devices_agree(env: BatchedEnv, batch: int, steps: int, dev_a, dev_b,
                  seed: int = 0) -> dict:
    """The same rollout on two devices: carry and every per-step reward
    bit-equal.  Returns the counts compared."""
    a = rollout_on(dev_a, env, batch, steps, seed)
    b = rollout_on(dev_b, env, batch, steps, seed)
    n = assert_bit_equal(a, b, f"{dev_a} vs {dev_b}")
    return {"envs": batch, "steps": steps, "elements": n,
            "reward_sum": float(np.sum(a[1], dtype=np.float64))}


# ---------------------------------------------------------------------------
# Phase 2: headline rollout
# ---------------------------------------------------------------------------
def headline(batch: int = 4096, steps: int = 100, iters: int = 7) -> dict:
    env = bench.headline_env()
    compiled, compile_s, rates = bench.time_rollout(env, batch, steps,
                                                    iters)
    q = statistics.quantiles(rates, n=4) if len(rates) > 1 else rates * 3
    return {"envs": batch, "steps": steps, "compile_s": compile_s,
            "memory": str(compiled.memory_analysis()),
            "median_env_steps_per_s": statistics.median(rates),
            "q1": q[0], "q3": q[2], "min": min(rates), "max": max(rates),
            "runs": len(rates)}


# ---------------------------------------------------------------------------
# Phase 3: trainer
# ---------------------------------------------------------------------------
def trainer_config(n_envs: int = 4096, hidden=FULL_MLP,
                   episode_limit: int = 100, iterations: int = 3,
                   ckpt_dir: str = "", n_synthetic_tasks: int = 32,
                   seed: int = 0) -> RunConfig:
    """``train.py``'s configuration (``--algo ppo``, defaults otherwise);
    tests shrink the sizes."""
    return RunConfig(seed=seed, algo="ppo", total_iterations=iterations,
                     checkpoint_dir=ckpt_dir, mlp_hidden=tuple(hidden),
                     env=EnvConfig(family="o2arc_crop33", n_envs=n_envs,
                                   episode_limit=episode_limit,
                                   n_synthetic_tasks=n_synthetic_tasks))


def trainer(cfg: RunConfig) -> dict:
    """``run_ppo`` for ``cfg.total_iterations`` iterations: every logged
    loss finite, every parameter leaf moved, a checkpoint written."""
    with tempfile.TemporaryDirectory() as td:
        cfg0 = trainer_config(cfg.env.n_envs, cfg.mlp_hidden,
                              cfg.env.episode_limit, 0,
                              os.path.join(td, "ck0"),
                              cfg.env.n_synthetic_tasks, cfg.seed)
        p0 = to_host(run_ppo(cfg0, MetricLogger(None)))
        log_path = os.path.join(td, "log.jsonl")
        cfg = dataclasses.replace(cfg, checkpoint_dir=os.path.join(td, "ck"))
        p1 = to_host(run_ppo(cfg, MetricLogger(log_path)))
        rows = [json.loads(line) for line in open(log_path)]
        latest = Checkpointer(cfg.checkpoint_dir).latest_step()
    losses = [r["total_loss"] for r in rows]
    if len(rows) != cfg.total_iterations or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    moved = jax.tree.leaves(jax.tree.map(
        lambda a, b: bool(np.any(a != b)), p0, p1))
    if not all(moved):
        raise AssertionError(f"{moved.count(False)} parameter leaves "
                             f"did not change")
    if latest is None:
        raise AssertionError("no checkpoint written")
    T = cfg.env.episode_limit
    ms = [cfg.env.n_envs * T / r["env_steps_per_s"] * 1e3 for r in rows]
    n_params = sum(x.size for x in jax.tree.leaves(p1))
    return {"envs": cfg.env.n_envs, "T": T, "params": int(n_params),
            "losses": losses, "ms_per_iter": ms, "checkpoint_step": latest,
            "matmul_precision":
                str(jax.config.jax_default_matmul_precision)}


def mlp_deviation(n_envs: int = 4096, hidden=FULL_MLP, seed: int = 0) -> dict:
    """FCPolicy's forward on real observations against the float64 NumPy
    reference, at precision "highest" and at the trainer's default."""
    cfg = trainer_config(n_envs=n_envs, hidden=hidden)
    env = make_ppo_env(cfg)
    obs = flatten_obs(reset_jit(env, jax.random.key(seed), n_envs).env)
    policy = FCPolicy(hidden=tuple(hidden), n_ops=env.table.n_ops)
    params = policy.init(jax.random.key(seed + 1), obs[:1])
    ref_logits, ref_value = fc_policy_reference(params, np.asarray(obs))

    def forward(params, obs):
        logits, value = policy.apply(params, obs)
        return jnp.concatenate(logits, -1), value

    def forward_highest(params, obs):
        with jax.default_matmul_precision("highest"):
            return forward(params, obs)

    out = {}
    for name, f in (("highest", forward_highest), ("default", forward)):
        logits, value = to_host(jax.jit(f)(params, obs))
        dev = max(np.abs(logits - ref_logits).max() / np.abs(ref_logits).max(),
                  np.abs(value - ref_value).max() / np.abs(ref_value).max())
        if not dev <= MLP_TOL[name]:
            raise AssertionError(f"MLP forward at {name} precision deviates "
                                 f"{dev:.3e} > {MLP_TOL[name]:.0e}")
        out[name] = float(dev)
    return out


# ---------------------------------------------------------------------------
# --four: data-parallel trainer across cards
# ---------------------------------------------------------------------------
def dp_ppo(devices, envs_per_device: int = 4096, iterations: int = 2,
           hidden=FULL_MLP, episode_limit: int = 100,
           n_synthetic_tasks: int = 32, seed: int = 0) -> dict:
    """``iterations`` jitted PPO iterations with the env batch sharded over
    a flat ``data`` mesh of ``devices`` and params replicated (XLA inserts
    the gradient all-reduce), against the same global batch on
    ``devices[0]`` alone.  The env carry must be bit-equal; loss and
    params agree to the reduction order (see the tolerances below)."""
    n = len(devices)
    cfg = trainer_config(n * envs_per_device, hidden, episode_limit,
                         iterations, n_synthetic_tasks=n_synthetic_tasks,
                         seed=seed)
    env = make_ppo_env(cfg)
    agent = build_agent(cfg)
    tx = make_optimizer(cfg.ppo)
    iteration = jax.jit(compose_iteration(*ppo_iteration_parts(cfg, agent,
                                                                tx)))
    with jax.default_device(devices[0]):
        key, ki, kr = jax.random.split(jax.random.key(seed), 3)
        bs = reset_jit(env, kr, cfg.env.n_envs)
        params = agent.init_fn(ki, agent.obs_fn(
            jax.tree.map(lambda x: x[:1], bs.env)))
        opt_state = tx.init(params)
    init = to_host(params)

    def run(env, bs, params, opt_state, key):
        losses = []
        for _ in range(iterations):
            bs, params, opt_state, key, stats = iteration(
                env, bs, params, opt_state, key)
            losses.append(float(stats["total_loss"]))
        return bs, params, losses

    bs1, p1, loss_one = run(*jax.device_put(
        (env, bs, params, opt_state, key), devices[0]))
    one = to_host((bs1, p1))
    del bs1, p1
    mesh = make_mesh((n,), ("data",), devices=devices)
    bsn, pn, loss_dp = run(
        replicate(env, mesh), shard_leading(bs, mesh, "data"),
        replicate(params, mesh), replicate(opt_state, mesh),
        replicate(key, mesh))
    spans = len(bsn.env.grid.sharding.device_set)
    if spans != n:
        raise AssertionError(f"carry sharded over {spans} devices, not {n}")
    dp = to_host((bsn, pn))
    n_carry = assert_bit_equal(one[0], dp[0], "env carry, 1 vs "
                               f"{n} devices")
    # Adam moves a parameter by at most about lr per step, so the update
    # is the scale: DP and single-card params may differ only in the
    # last bits of the gradient sums (all-reduce order), i.e. by a small
    # fraction of the update itself.
    flat = lambda t: np.concatenate([x.ravel() for x in jax.tree.leaves(t)])
    p_one, p_dp, p0 = flat(one[1]), flat(dp[1]), flat(init)
    param_rel = float(np.linalg.norm(p_dp - p_one)
                      / np.linalg.norm(p_one - p0))
    loss_rel = max(abs(a - b) / max(abs(a), 1e-12)
                   for a, b in zip(loss_one, loss_dp))
    if not (param_rel < 1e-2 and loss_rel < 1e-3):
        raise AssertionError(f"DP vs one card: params {param_rel:.2e} of "
                             f"the update, loss {loss_rel:.2e}")
    return {"devices": n, "global_envs": cfg.env.n_envs,
            "iterations": iterations, "carry_elements": n_carry,
            "loss_one": loss_one, "loss_dp": loss_dp,
            "loss_rel_diff": loss_rel, "param_diff_over_update": param_rel,
            "param_max_abs_diff": float(np.abs(p_dp - p_one).max())}


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the data-parallel trainer on four GPUs and "
                         "its comparison with one GPU")
    args = ap.parse_args(argv)

    cache = enable_compile_cache()
    devs = jax.devices()
    log(f"jax {jax.__version__}; devices {devs}; compile cache {cache}")
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's first device is {devs[0].platform}; "
              f"nothing run", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")
    dev = devs[0]
    t_all = time.perf_counter()

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        log(f"[{name}] {json.dumps(out)} ({time.perf_counter() - t0:.1f}s)")
        return out

    if args.four:
        if len(devs) < 4:
            print(f"--four needs 4 GPUs, JAX sees {len(devs)}",
                  file=sys.stderr)
            return 2
        phase("dp_ppo", dp_ppo, devs[:4])
    else:
        cpu = jax.devices("cpu")[0]
        for family in ("o2arc", "arc", "raw"):
            phase(f"oracle_parity {family}", oracle_parity, family)
        phase("gpu_vs_cpu o2arc", devices_agree, bench.headline_env(),
              4096, 100, dev, cpu)
        phase("gpu_vs_cpu answer_given", devices_agree, answer_given_env(),
              4096, 100, dev, cpu)
        phase("headline", headline)
        phase("trainer", trainer, trainer_config())
        phase("mlp_vs_float64", mlp_deviation)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f}s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
