#!/usr/bin/env python
"""Benchmark: O2ARCv2 env-steps/s at 4096 lockstep envs on one GPU.

Rollout shape mirrors the training hot path: a ``lax.scan`` over T steps,
each step drawing random bbox actions on device (the BBoxWrapper action
surface, 5 ints -> selection mask) and stepping the full 35-op fused
transition with auto-reset.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "env-steps/s", "vs_baseline": N,
     "device": {...}, "card": "<name>, <power limit>", ...}

Exits non-zero, printing no result, when JAX's first device is not a GPU.

``vs_baseline`` is the speedup over the *reference implementation*
(ConfeitoHS/arcle, pure NumPy, single env) measured in-process on this
machine — the reference publishes no throughput numbers of its own
(SURVEY.md §6), so its measured step rate is the honest baseline.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import numpy as np

from arcle_tpu.benchmarks import roofline
from arcle_tpu.core.geometry import bbox_selection, point_selection
from arcle_tpu.core.state import Action
from arcle_tpu.envs import BatchedEnv
from arcle_tpu.envs.core import flatten_grids, reset_jit, unflatten_grids
from arcle_tpu.loaders import ARCLoader, MiniARCLoader, SyntheticLoader
from arcle_tpu.loaders.synthetic import write_corpus
from arcle_tpu.models.mlp import FCPolicy
from arcle_tpu.ops import arc_table, o2arc_table, raw_table
from arcle_tpu.training.agents import mlp_agent
from arcle_tpu.training.ppo import (
    PPOConfig, batch_from_trajectory, make_optimizer, train_step)
from arcle_tpu.training.rollout import rollout
from arcle_tpu.utils.compile_cache import enable_compile_cache


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def require_gpu():
    """Exit non-zero unless JAX's first device is a GPU: this benchmark
    measures the card, and a number from any other device is no result."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); nothing measured")
        sys.exit(2)
    return dev


def bench_reference_numpy(n_steps: int = 3000, seed: int = 0) -> float:
    """Step rate of the reference env (fallback: the validated oracle)."""
    rng = np.random.default_rng(seed)
    inp = rng.integers(0, 10, (12, 12)).astype(np.int8)
    out = rng.integers(0, 10, (12, 12)).astype(np.int8)

    def random_action():
        x1, x2 = sorted(rng.integers(0, 30, 2).tolist())
        y1, y2 = sorted(rng.integers(0, 30, 2).tolist())
        sel = np.zeros((30, 30), np.int8)
        sel[x1:x2 + 1, y1:y2 + 1] = 1
        return sel, int(rng.integers(0, 35))

    try:
        sys.path.insert(0, "/root/reference")
        from arcle.envs.o2arcenv import O2ARCv2Env as RefEnv
        from arcle.loaders import Loader

        class OneTask(Loader):
            def get_path(self, **kw):
                return ["<mem>"]

            def parse(self, **kw):
                return [([inp], [out], [inp], [out], {"id": "bench"})]

        env = RefEnv(data_loader=OneTask(), max_trial=-1)
        env.reset(options={"prob_index": 0, "subprob_index": 0})
        t0 = time.perf_counter()
        done_steps = 0
        while done_steps < n_steps:
            sel, op = random_action()
            _, _, term, _, _ = env.step({"selection": sel, "operation": op})
            done_steps += 1
            if term:
                env.reset(options={"prob_index": 0, "subprob_index": 0})
        dt = time.perf_counter() - t0
        log(f"reference numpy single-env: {done_steps / dt:,.0f} steps/s")
        return done_steps / dt
    except Exception as e:  # pragma: no cover
        log(f"reference not runnable ({e}); using NumPy oracle as baseline")
        from arcle_tpu.oracle import OracleEnv
        env = OracleEnv("o2arc", max_trial=-1)
        env.reset(inp, out)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            sel, op = random_action()
            _, _, term = env.step(sel, op)
            if term:
                env.reset(inp, out)
        dt = time.perf_counter() - t0
        log(f"oracle numpy single-env: {n_steps / dt:,.0f} steps/s")
        return n_steps / dt


def headline_env(table=None, bank=None) -> BatchedEnv:
    """The headline cell's env: O2ARCv2 ops (unless ``table``), a 16-task
    bank generated from a seed (unless ``bank``), 100-step episodes with
    auto-reset from a pre-drawn pool of 8 per env (the mechanism run_ppo
    uses)."""
    return BatchedEnv(
        table=o2arc_table(max_trial=-1) if table is None else table,
        bank=SyntheticLoader(16, seed=3).bank() if bank is None else bank,
        max_trial=-1, episode_limit=100, auto_reset=True, reset_pool=8)


def random_rollout(env: BatchedEnv, bs, key, steps: int,
                   point_actions: bool = False):
    """``steps`` lockstep steps with uniformly random bbox (or point)
    actions drawn on device — the BBoxWrapper action surface, 5 ints ->
    selection mask — through ``BatchedEnv.step`` with auto-reset.  The
    carry rides flat between steps as in ``training.rollout``.  Returns
    (carry, key, rewards [steps, B]).  Jit with ``steps`` (and
    ``point_actions``) static."""
    H, W = env.bank.in_grids.shape[-2:]
    batch = bs.batch

    def random_actions(key):
        k1, k2 = jax.random.split(key)
        ops = jax.random.randint(k2, (batch,), 0, env.table.n_ops)
        if point_actions:
            c = jax.random.randint(k1, (2, batch), 0, H)
            sels = jax.vmap(point_selection, in_axes=(0, 0, None, None))(
                c[0], c[1], H, W)
        else:
            c = jax.random.randint(k1, (4, batch), 0, H)
            sels = jax.vmap(bbox_selection,
                            in_axes=(0, 0, 0, 0, None, None))(
                c[0], c[1], c[2], c[3], H, W)
        return Action(selection=sels, operation=ops)

    def body(carry, _):
        bs_flat, key = carry
        key, ka = jax.random.split(key)
        with jax.named_scope("actions"):
            act = random_actions(ka)
        b, _obs, rew, _term, _trunc = env.step(
            unflatten_grids(bs_flat, H, W), act)
        return (flatten_grids(b, H, W), key), rew

    (bs_flat, key), rews = jax.lax.scan(
        body, (flatten_grids(bs, H, W), key), None, length=steps)
    return unflatten_grids(bs_flat, H, W), key, rews


def time_rollout(env: BatchedEnv, batch: int, steps: int, iters: int,
                 seed: int = 0, point_actions: bool = False):
    """Compile the random-action rollout and run it ``iters`` times, each
    ending in ``jax.block_until_ready``.  Returns (compiled program,
    compile seconds, per-run env-steps/s)."""
    key = jax.random.key(seed)
    bs = reset_jit(env, key, batch)
    rj = jax.jit(random_rollout, static_argnums=(3, 4))
    t0 = time.perf_counter()
    compiled = rj.lower(env, bs, key, steps, point_actions).compile()
    compile_s = time.perf_counter() - t0
    bs, key, _ = jax.block_until_ready(compiled(env, bs, key))   # warm-up
    rates = []
    for it in range(iters):
        t0 = time.perf_counter()
        bs, key, rews = jax.block_until_ready(compiled(env, bs, key))
        dt = time.perf_counter() - t0
        rates.append(batch * steps / dt)
        log(f"iter {it}: {rates[-1]:,.0f} env-steps/s ({dt * 1e3:.1f} ms "
            f"for {batch}x{steps})")
    return compiled, compile_s, rates


def bench_engine(batch: int, steps: int, iters: int, seed: int = 0,
                 table=None, bank=None, point_actions: bool = False,
                 util_out: dict = None) -> float:
    """Best env-steps/s of ``iters`` timed random-action rollouts."""
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind}")
    env = headline_env(table, bank)
    compiled, compile_s, rates = time_rollout(env, batch, steps, iters,
                                              seed, point_actions)
    log(f"compile: {compile_s:.1f}s")
    best = max(rates)
    if util_out is not None:
        # roofline accounting: XLA cost model of the whole compiled
        # rollout, as % of the card's peaks at the measured rate
        util_out.update(roofline.summarize(
            best, batch, steps, roofline.cost_from_compiled(compiled),
            kind=dev.device_kind,
            card=roofline.card_name_and_power_limit()))
        log(f"roofline: {util_out}")
    return best


def bench_scaling(batch_per_device: int, steps: int):
    """Sharded-throughput harness: same per-device env batch, increasing
    device counts; reports steps/s/device and scaling efficiency (env
    stepping needs no cross-device communication, so efficiency should be
    ~100%)."""
    from arcle_tpu.parallel import make_mesh, shard_leading

    env = BatchedEnv(table=o2arc_table(max_trial=-1),
                     bank=SyntheticLoader(16, seed=3).bank(),
                     max_trial=-1, episode_limit=100, auto_reset=True)
    n_dev = len(jax.devices())
    base_rate = None
    results = {}
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    for n in counts:
        mesh = make_mesh((n,), ("data",), devices=jax.devices()[:n])
        B = batch_per_device * n

        def random_actions(key):
            k1, k2 = jax.random.split(key)
            c = jax.random.randint(k1, (4, B), 0, 30)
            ops = jax.random.randint(k2, (B,), 0, env.table.n_ops)
            sels = jax.vmap(bbox_selection,
                            in_axes=(0, 0, 0, 0, None, None))(
                c[0], c[1], c[2], c[3], 30, 30)
            return Action(selection=sels, operation=ops)

        def rollout(env, bs, key):
            def body(carry, _):
                bs, key = carry
                key, ka = jax.random.split(key)
                bs, _o, rew, term, trunc = env.step(bs, random_actions(ka))
                return (bs, key), rew.sum()
            (bs, key), r = jax.lax.scan(body, (bs, key), None, length=steps)
            return bs, r

        bs = shard_leading(env.reset(jax.random.key(0), B), mesh, "data")
        env_s = shard_leading(env, mesh, "data")
        with mesh:
            rj = jax.jit(rollout)
            out = jax.block_until_ready(rj(env_s, bs, jax.random.key(1)))
            best = 1e9
            for _ in range(2):
                t0 = time.perf_counter()
                out = jax.block_until_ready(
                    rj(env_s, out[0], jax.random.key(2)))
                best = min(best, time.perf_counter() - t0)
        rate = B * steps / best
        per_dev = rate / n
        if base_rate is None:
            base_rate = per_dev
        eff = per_dev / base_rate * 100
        results[n] = (rate, eff)
        log(f"devices={n}: {rate:,.0f} steps/s total, "
            f"{per_dev:,.0f}/device, efficiency {eff:.1f}%")
    return results


def bench_single_env_adapter(n_steps: int = 30000, seed: int = 0) -> float:
    """BASELINE config 1 the way a *user* runs it: the gym adapter
    (``RawARCEnv`` + MiniARC loader) stepped one action at a time — the
    same surface `bench_reference_numpy` measures on the reference.  The
    adapter routes B=1 through the native C++ engine (bit-exact vs the
    oracle, tests/test_native_engine.py), so the interactive path beats
    the reference instead of paying per-step device dispatch."""
    from arcle_tpu.envs.gym_compat import RawARCEnv

    rng = np.random.default_rng(seed)
    env = RawARCEnv(data_loader=MiniARCLoader(), max_trial=-1)
    env.reset(seed=seed, options={"prob_index": 0, "subprob_index": 0})
    n_ops = len(env.operations)
    log(f"single-env adapter backend: "
        f"{'native' if env._native is not None else 'jax'}")
    t0 = time.perf_counter()
    done = 0
    while done < n_steps:
        x1, x2 = sorted(rng.integers(0, 30, 2).tolist())
        y1, y2 = sorted(rng.integers(0, 30, 2).tolist())
        sel = np.zeros((30, 30), np.int8)
        sel[x1:x2 + 1, y1:y2 + 1] = 1
        _, _, term, _, _ = env.step(
            {"selection": sel, "operation": int(rng.integers(0, n_ops))})
        done += 1
        if term:
            env.reset(options={"prob_index": 0, "subprob_index": 0})
    rate = done / (time.perf_counter() - t0)
    log(f"single-env gym adapter: {rate:,.0f} steps/s")
    return rate


def bench_baseline_configs(steps: int) -> dict:
    """BASELINE.json configs 1-3 (Raw@1 and @256, ARCEnv+Point@1024) plus
    the reset/auto-reset gather cost on a reference-scale (~3200-pair)
    TaskBank at 4096 envs."""
    import tempfile

    out = {}
    # config 1: RawARCEnv + MiniARCLoader, 1 env — the interactive gym
    # surface (native C++ engine at B=1)
    out["raw_miniarc_1env"] = round(bench_single_env_adapter())
    # config 2: RawARCEnv + ARC-format corpus, 256 envs
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        n_pairs = write_corpus(td, n_tasks=400, n_train=6, n_test=2)
        arc_bank = ARCLoader(root=td).bank()
        log(f"400-task corpus ({n_pairs} pairs) generated+baked in "
            f"{time.perf_counter() - t0:.1f}s")
    out["raw_arc_256env"] = round(bench_engine(
        256, steps, 2, table=raw_table(max_trial=-1), bank=arc_bank))
    # config 3: ARCEnv intent (27 ops) + PointWrapper, 1024 envs
    out["arc_point_1024env"] = round(bench_engine(
        1024, steps, 2, table=arc_table(max_trial=-1), bank=arc_bank,
        point_actions=True))
    # reset/auto-reset gather cost at 4096 envs on the ~3200-pair bank
    env = BatchedEnv(table=o2arc_table(max_trial=-1), bank=arc_bank,
                     max_trial=-1, episode_limit=100, auto_reset=True)

    jax.block_until_ready(reset_jit(env, jax.random.key(0), 4096))
    best = float("inf")
    for i in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(reset_jit(env, jax.random.key(1 + i), 4096))
        best = min(best, time.perf_counter() - t0)
    out["reset_4096env_3200pair_ms"] = round(best * 1e3, 1)
    # the eager path for the record (what a naive caller pays per reset)
    t0 = time.perf_counter()
    jax.block_until_ready(env.reset(jax.random.key(2), 4096))
    out["reset_4096env_eager_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 1)
    out["corpus_pairs"] = n_pairs
    log(f"baseline configs: {out}")
    return out


def bench_train_loop(batch: int, steps: int, iters: int = 3) -> float:
    """The BASELINE north-star configuration: B lockstep O2ARC envs with
    dense reward + augmentation *feeding a PPO learner* — one fused jitted
    iteration (rollout with the MLP policy + GAE + full-batch update),
    exactly what run_ppo executes.  Returns env-steps/s including the
    learner."""
    env = BatchedEnv(table=o2arc_table(127, crop_at_33=True),
                     bank=SyntheticLoader(32, seed=7).bank(), max_trial=127,
                     episode_limit=100, auto_reset=True, dense_reward=True,
                     augment=True, reset_pool=8)
    agent = mlp_agent(FCPolicy(hidden=(1024, 1024, 512, 512, 256, 128),
                               n_ops=env.table.n_ops))
    cfg = PPOConfig()
    key = jax.random.key(0)
    key, ki, kr = jax.random.split(key, 3)
    bs = env.reset(kr, batch)
    params = agent.init_fn(ki, agent.obs_fn(
        jax.tree.map(lambda x: x[:1], bs.env)))
    tx = make_optimizer(cfg)
    opt_state = tx.init(params)

    def iteration(env, bs, params, opt_state, key):
        key, kroll, ktrain = jax.random.split(key, 3)
        bs, traj, last_v = rollout(env, bs, params, kroll, steps, agent)
        batch_ = batch_from_trajectory(traj, last_v, cfg)
        params, opt_state, stats = train_step(
            params, opt_state, batch_, ktrain, agent, tx, cfg)
        return bs, params, opt_state, key, stats["total_loss"]

    it_j = jax.jit(iteration)
    out = jax.block_until_ready(it_j(env, bs, params, opt_state, key))
    best = 1e9
    for _i in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(it_j(env, bs, out[1], out[2], out[3]))
        best = min(best, time.perf_counter() - t0)
    rate = batch * steps / best
    log(f"ppo train loop: {best * 1e3:.1f} ms/iter -> {rate:,.0f} "
        f"env-steps/s incl. learner")
    return rate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ref-steps", type=int, default=3000)
    ap.add_argument("--skip-ref", action="store_true")
    ap.add_argument("--headline-only", action="store_true",
                    help="skip the BASELINE configs 1-3 sweep")
    ap.add_argument("--scaling", action="store_true",
                    help="multi-device scaling harness instead of the "
                         "single-chip benchmark")
    args = ap.parse_args()

    enable_compile_cache()
    dev = require_gpu()

    if args.scaling:
        results = bench_scaling(max(args.batch // 8, 64), min(args.steps, 20))
        n = max(results)
        rate, eff = results[n]
        print(json.dumps({
            "metric": f"O2ARCv2 sharded env-steps/s @ {n} devices",
            "value": round(rate), "unit": "env-steps/s",
            "vs_baseline": round(eff, 1),
        }))
        return

    if args.skip_ref:
        ref_rate = 1.0
    else:
        ref_rate = bench_reference_numpy(args.ref_steps)

    util = {}
    rate = bench_engine(args.batch, args.steps, args.iters, util_out=util)

    result = {
        "metric": f"O2ARCv2 env-steps/s @ {args.batch} lockstep envs "
                  f"(random bbox actions, auto-reset)",
        "value": round(rate),
        "unit": "env-steps/s",
        "vs_baseline": round(rate / ref_rate, 2),
    }
    result["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    result["card"] = util["card"]
    result["roofline"] = util
    if not args.headline_only:
        result["configs"] = bench_baseline_configs(min(args.steps, 100))
        # the BASELINE north star: envs *feeding a PPO learner*
        result["ppo_train_loop_steps_per_s"] = round(
            bench_train_loop(args.batch, args.steps))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
