#!/usr/bin/env python
"""Isolate where the ~4.4 ms/step policy-in-loop overhead goes.

Variants of the rollout scan body, each timed to ``jax.block_until_ready``:

  env_only   random actions, no policy            (engine ceiling)
  full       the library rollout body              (baseline)
  nofv       no truncation-bootstrap cond/fv      (cond + 2nd fwd cost)
  sever      policy computed + stored, but env    (serialization cost)
             steps on random actions
  noobs      obs not stored in the trajectory     (obs-store cost)
  tiny       hidden=(32,) MLP                     (MLP-size scaling)
  no_sample  policy fwd only, argmax op, no RNG   (sampler cost)

Usage: python scripts/probe_rollout.py [--batch 4096] [--steps 100]
       [--variants full,nofv,...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp

from arcle_tpu.envs import BatchedEnv
from arcle_tpu.envs.core import flatten_grids, unflatten_grids
from arcle_tpu.loaders import SyntheticLoader
from arcle_tpu.models.mlp import FCPolicy
from arcle_tpu.ops import o2arc_table
from arcle_tpu.training.agents import mlp_agent
from arcle_tpu.training.rollout import decode_bbox_actions


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timeit(name, fn, *args, iters=3):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))    # compile + warm-up
    log(f"{name:10s} compile {time.perf_counter() - t0:6.1f}s")
    best = 1e9
    for _i in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    log(f"{name:10s} {best * 1e3:8.1f} ms")
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--variants",
                    default="env_only,full,nofv,sever,noobs,tiny,no_sample")
    args = ap.parse_args()
    B, T = args.batch, args.steps

    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind}; B={B} T={T}")
    env = BatchedEnv(table=o2arc_table(127, crop_at_33=True),
                     bank=SyntheticLoader(32, seed=7).bank(), max_trial=127,
                     episode_limit=100, auto_reset=True, dense_reward=True,
                     augment=True)
    agent = mlp_agent(FCPolicy(hidden=(1024, 1024, 512, 512, 256, 128),
                               n_ops=env.table.n_ops))
    tiny = mlp_agent(FCPolicy(hidden=(32,), n_ops=env.table.n_ops))

    key = jax.random.key(0)
    key, ki, kr, kt = jax.random.split(key, 4)
    bs = env.reset(kr, B)
    obs1 = agent.obs_fn(jax.tree.map(lambda x: x[:1], bs.env))
    params = agent.init_fn(ki, obs1)
    tiny_params = tiny.init_fn(kt, obs1)

    def make(variant, ag):
        store_obs = variant != "noobs"
        use_policy_action = variant not in ("env_only", "sever")
        with_fv = variant == "full"
        with_policy = variant != "env_only"
        with_sample = variant != "no_sample"

        def run(env, bs, params, key):
            def body(carry, _):
                bs_flat, k = carry
                k, ka = jax.random.split(k)
                acc = jnp.float32(0)
                if with_policy:
                    obs = ag.obs_fn(unflatten_grids(bs_flat).env)
                    if with_sample:
                        acts, lp, value = ag.sample_fn(params, obs, ka)
                    else:
                        lt, value = (None, None)
                        # forward + argmax only (no RNG, no logp)
                        from arcle_tpu.models.mlp import stack_padded_logits
                        fc = FCPolicy(hidden=(1024, 1024, 512, 512, 256,
                                              128), n_ops=env.table.n_ops)
                        ltup, value = fc.apply(params, obs)
                        acts = jnp.argmax(stack_padded_logits(ltup),
                                          -1).astype(jnp.int32)
                        lp = value * 0
                    acc = acc + lp.sum() + value.sum()
                    if store_obs:
                        acc = acc + obs.astype(jnp.float32).sum()
                if use_policy_action:
                    a5 = acts
                else:
                    c = jax.random.randint(ka, (5, B), 0, 30)
                    a5 = jnp.stack([c[0], c[1], c[2], c[3],
                                    c[4] % env.table.n_ops], -1)
                b2, obs_env, rew, te, tr = env.step(
                    unflatten_grids(bs_flat), decode_bbox_actions(a5))
                bs2 = flatten_grids(b2)
                if with_fv:
                    need = tr & ~te

                    def compute_fv(_):
                        _, v_fin, _ = ag.evaluate_fn(
                            params, ag.obs_fn(obs_env), a5)
                        return v_fin

                    fv = jax.lax.cond(jnp.any(need), compute_fv,
                                      lambda _: jnp.zeros((B,), jnp.float32),
                                      None)
                    acc = acc + fv.sum()
                acc = acc + rew.sum()
                # store obs in the carry-out (scan stacks it like traj)
                out = (acc, obs if (with_policy and store_obs) else rew)
                return (bs2, k), out

            (bs_fin, _), (accs, stored) = jax.lax.scan(
                body, (flatten_grids(bs), key), None, length=T)
            return accs.sum() + stored.astype(jnp.float32).sum() * 1e-9

        return run

    results = {}
    for variant in args.variants.split(","):
        ag = tiny if variant == "tiny" else agent
        p = tiny_params if variant == "tiny" else params
        fn = jax.jit(make(variant, ag))
        dt = timeit(variant, fn, env, bs, p, key)
        results[variant + "_ms"] = round(dt * 1e3, 1)
    results.update(batch=B, steps=T)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
