#!/usr/bin/env python
"""Per-phase profile of one PPO iteration (the VERDICT round-1 ask:
where do the ~900 ms at B=4096 go — policy fwd, env step, GAE, update?).

Each phase is jitted separately, timed to ``jax.block_until_ready`` after
a warmup call.  Phases:

  env_step   - rollout with random actions, no policy (engine ceiling)
  rollout    - rollout() with the policy in the loop
  gae_batch  - batch_from_trajectory (GAE + flatten + adv normalization)
  update     - train_step (one epoch, full batch)
  iteration  - the full fused iteration as run_ppo jits it

Usage: python scripts/profile_ppo.py [--batch 4096] [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp

from arcle_tpu.envs import BatchedEnv
from arcle_tpu.loaders import SyntheticLoader
from arcle_tpu.ops import o2arc_table
from arcle_tpu.models.mlp import FCPolicy
from arcle_tpu.training.agents import mlp_agent
from arcle_tpu.training.ppo import (
    PPOConfig, batch_from_trajectory, make_optimizer, train_step,
)
from arcle_tpu.training.rollout import rollout, decode_bbox_actions
from arcle_tpu.envs.core import flatten_grids, unflatten_grids


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timeit(name, fn, *args, iters=3):
    out = jax.block_until_ready(fn(*args))    # warmup + compile
    best = 1e9
    for _i in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    log(f"{name:12s} {best * 1e3:8.1f} ms")
    return best, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--hidden", default="1024,1024,512,512,256,128")
    ap.add_argument("--reset-pool", type=int, default=0)
    args = ap.parse_args()
    B, T = args.batch, args.steps
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32

    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind}; B={B} T={T} "
        f"dtype={args.dtype}")
    env = BatchedEnv(table=o2arc_table(127, crop_at_33=True),
                     bank=SyntheticLoader(32, seed=7).bank(), max_trial=127,
                     episode_limit=100, auto_reset=True, dense_reward=True,
                     augment=True, reset_pool=args.reset_pool)
    hidden = tuple(int(x) for x in args.hidden.split(","))
    agent = mlp_agent(FCPolicy(hidden=hidden, n_ops=env.table.n_ops,
                               dtype=dtype))
    cfg = PPOConfig()
    key = jax.random.key(0)
    key, ki, kr = jax.random.split(key, 3)
    bs = env.reset(kr, B)
    params = agent.init_fn(ki, agent.obs_fn(
        jax.tree.map(lambda x: x[:1], bs.env)))
    tx = make_optimizer(cfg)
    opt_state = tx.init(params)

    results = {}

    # --- env-only ceiling -------------------------------------------------
    def env_only(env, bs, key):
        def body(carry, _):
            bs_flat, k = carry
            k, ka = jax.random.split(k)
            c = jax.random.randint(ka, (5, B), 0, 30)
            ops = c[4] % env.table.n_ops
            acts = jnp.stack([c[0], c[1], c[2], c[3], ops], -1)
            b2, _o, rew, te, tr = env.step(
                unflatten_grids(bs_flat), decode_bbox_actions(acts))
            bs_flat = flatten_grids(b2)
            return (bs_flat, k), rew.sum()
        (bs_flat, _), r = jax.lax.scan(body, (flatten_grids(bs), key),
                                       None, length=T)
        return unflatten_grids(bs_flat), r.sum() + 0.0

    dt, _ = timeit("env_step", jax.jit(env_only), env, bs, key)
    results["env_step_ms"] = dt * 1e3

    # --- rollout with policy ---------------------------------------------
    def roll(env, bs, params, key):
        bs2, traj, last_v = rollout(env, bs, params, key, T, agent)
        return bs2, traj, last_v, traj.rewards.sum() + last_v.sum()

    dt, (bs2, traj, last_v, _) = timeit(
        "rollout", jax.jit(roll), env, bs, params, key)
    results["rollout_ms"] = dt * 1e3

    # --- GAE + batch building --------------------------------------------
    def gb(traj, last_v):
        batch = batch_from_trajectory(traj, last_v, cfg)
        return batch, batch.advantages.sum() + batch.obs.astype(
            jnp.float32).sum()

    dt, (batch, _) = timeit("gae_batch", jax.jit(gb), traj, last_v)
    results["gae_batch_ms"] = dt * 1e3

    # --- learner update ---------------------------------------------------
    def upd(params, opt_state, batch, key):
        p2, o2, stats = train_step(params, opt_state, batch, key, agent,
                                   tx, cfg)
        return p2, o2, stats["total_loss"] + 0.0

    dt, _ = timeit("update", jax.jit(upd), params, opt_state, batch, key)
    results["update_ms"] = dt * 1e3

    # --- full fused iteration (what run_ppo times) ------------------------
    def iteration(env, bs, params, opt_state, key):
        key, kroll, ktrain = jax.random.split(key, 3)
        bs, traj, last_v = rollout(env, bs, params, kroll, T, agent)
        batch = batch_from_trajectory(traj, last_v, cfg)
        params, opt_state, stats = train_step(
            params, opt_state, batch, ktrain, agent, tx, cfg)
        return bs, params, opt_state, key, stats["total_loss"] + 0.0

    dt, _ = timeit("iteration", jax.jit(iteration), env, bs, params,
                   opt_state, key)
    results["iteration_ms"] = dt * 1e3
    results["env_steps_per_s"] = B * T / dt
    results["batch"] = B
    results["dtype"] = args.dtype
    results["reset_pool"] = args.reset_pool
    print(json.dumps(results))


if __name__ == "__main__":
    main()
