"""MLP training driver — the counterpart of /root/reference/agents/train.py.

Same experiment envelope (train.py:43-102): CustomO2ARC-style env (crop at
33, augmentation, dense shaped reward, max_trial=127, TimeLimit 100), MLP
policy [1024,1024,512,512,256,128] tanh over FilterO2ARC+Flatten obs,
BBox-tuple action heads; E-MAML (10 tasks) or plain PPO; checkpoints every
N iterations; JSONL metric logging with the reference's wandb schema.

Run:  python -m arcle_tpu.training.train --algo emaml --iterations 100
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..envs import BatchedEnv, ResetOptions, reset_jit
from ..models.mlp import FCPolicy
from ..utils.config import RunConfig, EnvConfig, make_table, make_loader
from ..utils.metrics import MetricLogger, Throughput
from ..utils.checkpoint import Checkpointer
from ..utils.compile_cache import enable_compile_cache
from .agents import mlp_agent
from .ppo import PPOConfig, batch_from_trajectory, make_optimizer, train_step
from .emaml import (
    EMAMLConfig, init_emaml, emaml_train_step, make_chunked_train_step,
    sample_task_assignment,
)
from .rollout import rollout


def log_provenance(logger: MetricLogger, cfg: RunConfig, argv=None) -> None:
    """One JSONL header line per run record: full config, git sha, argv —
    so a committed curve is reproducible from the file alone."""
    import json
    import os
    import subprocess
    try:
        proc = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
             "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10)
        sha = proc.stdout.strip()
        # a git that ran but failed (not a checkout, detached worktree
        # error, ...) exits non-zero with empty stdout — record "unknown"
        # rather than an empty sha
        if proc.returncode != 0 or not sha:
            sha = "unknown"
    except Exception:
        sha = "unknown"
    logger.meta({"config": json.loads(cfg.to_json()), "git_sha": sha,
                 "argv": list(argv) if argv else sys.argv[1:]})


def build_agent(cfg: RunConfig):
    if cfg.model == "gpt":
        from ..models.gpt import GPTPolicy
        from .agents import gpt_agent
        return gpt_agent(GPTPolicy(cfg.gpt))
    dtype = jnp.bfloat16 if cfg.mlp_dtype in ("bf16", "bfloat16") \
        else jnp.float32
    policy = FCPolicy(hidden=tuple(cfg.mlp_hidden),
                      n_ops=make_table(cfg.env).n_ops, dtype=dtype)
    return mlp_agent(policy)


def _key_data(key):
    return jax.random.key_data(key)


def _wrap_key(data):
    return jax.random.wrap_key_data(jnp.asarray(data))


def ppo_iteration_parts(cfg: RunConfig, agent, tx):
    """The two halves of one PPO iteration as pure functions:
    ``roll_part(env, bs, params, key) -> (bs, batch, extras, key, ktrain)``
    (T-step rollout + GAE batch) and ``update_part(params, opt_state,
    batch, ktrain, extras) -> (params, opt_state, stats)``.  Join them
    with :func:`compose_iteration`."""
    T = cfg.env.episode_limit or 100
    include_aux = cfg.ppo.aux_coeff > 0.0 and agent.aux_fn is not None

    def roll_part(env, bs, params, key):
        key, kroll, ktrain = jax.random.split(key, 3)
        bs, traj, last_v = rollout(env, bs, params, kroll, T, agent)
        batch = batch_from_trajectory(traj, last_v, cfg.ppo,
                                      include_aux=include_aux)
        extras = {"episode_reward_mean": traj.rewards.sum(0).mean(),
                  # success = a true termination before truncation
                  # (sparse solve / trial exhaustion on a solve; valid
                  # for dense rewards too, unlike max-reward heuristics)
                  "success_rate": traj.terminated.any(0).mean()}
        return bs, batch, extras, key, ktrain

    def update_part(params, opt_state, batch, ktrain, extras):
        params, opt_state, stats = train_step(
            params, opt_state, batch, ktrain, agent, tx, cfg.ppo)
        stats = dict(stats)
        stats.update(extras)
        return params, opt_state, stats

    return roll_part, update_part


def compose_iteration(roll_fn, update_fn):
    """``iteration(env, bs, params, opt_state, key) -> (bs, params,
    opt_state, key, stats)`` from the two parts (jitted or not)."""
    def iteration(env, bs, params, opt_state, key):
        bs, batch, extras, key, ktrain = roll_fn(env, bs, params, key)
        params, opt_state, stats = update_fn(params, opt_state, batch,
                                             ktrain, extras)
        return bs, params, opt_state, key, stats
    return iteration


def make_ppo_env(cfg: RunConfig) -> BatchedEnv:
    """The auto-resetting lockstep env :func:`run_ppo` trains on."""
    return BatchedEnv(table=make_table(cfg.env),
                      bank=make_loader(cfg.env).bank(),
                      max_trial=cfg.env.max_trial,
                      episode_limit=cfg.env.episode_limit,
                      auto_reset=True, dense_reward=cfg.env.dense_reward,
                      augment=cfg.env.augment,
                      reset_pool=cfg.env.reset_pool)


def run_ppo(cfg: RunConfig, logger: MetricLogger, resume: bool = False):
    env = make_ppo_env(cfg)
    agent = build_agent(cfg)
    key = jax.random.key(cfg.seed)
    key, ki, kr = jax.random.split(key, 3)
    bs = env.reset(kr, cfg.env.n_envs)
    params = agent.init_fn(ki, agent.obs_fn(
        jax.tree.map(lambda x: x[:1], bs.env)))
    tx = make_optimizer(cfg.ppo)
    opt_state = tx.init(params)

    T = cfg.env.episode_limit or 100
    roll_part, update_part = ppo_iteration_parts(cfg, agent, tx)

    if cfg.ppo_chunked:
        # two jitted units instead of one fused program (large models
        # compile and run each unit on its own).  Identical numerics — the
        # same functions, just a host-level boundary between them.
        it_j = compose_iteration(jax.jit(roll_part), jax.jit(update_part))
    else:
        it_j = jax.jit(compose_iteration(roll_part, update_part))
    ckpt = Checkpointer(cfg.checkpoint_dir)
    start = 0
    if resume:
        # the reference resumes via RLlib checkpoints (algo.save /
        # Algorithm.from_checkpoint); here the whole training state is one
        # checkpointed tree
        tmpl = {"params": params, "opt_state": opt_state,
                "key": _key_data(key), "iteration": 0}
        restored = ckpt.restore(tmpl)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt_state"]
            key = _wrap_key(restored["key"])
            start = int(restored["iteration"]) + 1
            print(f"resumed from iteration {start - 1}", file=sys.stderr)
    thr = Throughput()
    for i in range(start, cfg.total_iterations):
        bs, params, opt_state, key, stats = it_j(env, bs, params,
                                                 opt_state, key)
        rate = thr.tick(cfg.env.n_envs * T, stats)
        if i % cfg.log_every == 0:
            stats = dict(stats)
            stats["env_steps_per_s"] = rate
            logger.log(i, stats)
        if i % 50 == 0:
            # stderr heartbeat: liveness signal for supervise.py
            print(f"[iter {i}] loss={float(stats['total_loss']):.4f} "
                  f"success={float(stats['success_rate']):.3f} "
                  f"{rate:,.0f} steps/s", file=sys.stderr, flush=True)
        if cfg.checkpoint_every and i % cfg.checkpoint_every == 0:
            ckpt.save(i, {"params": params, "opt_state": opt_state,
                          "key": _key_data(key), "iteration": i})
    return params


def run_emaml(cfg: RunConfig, logger: MetricLogger, resume: bool = False):
    import os
    import pickle

    table = make_table(cfg.env)
    bank = make_loader(cfg.env).bank()
    agent = build_agent(cfg)
    ecfg = cfg.emaml
    key = jax.random.key(cfg.seed)
    key, ki = jax.random.split(key)
    st = init_emaml(agent, ecfg, ki, n_bank_tasks=int(bank.n_tasks))
    if ecfg.chunked:
        # host-orchestrated step: short jitted units (~1 s each) instead
        # of one fused multi-minute program — the GPT-scale path (see
        # make_chunked_train_step).
        # ARCLE_TPU_PROFILE_UNITS=1 records a per-unit wall-clock
        # breakdown (rollout/update/chain/outer) into every JSONL line.
        profile = os.environ.get("ARCLE_TPU_PROFILE_UNITS", "") == "1"
        chunked_step = make_chunked_train_step(agent, ecfg, profile=profile)
        step_j = lambda st, env, bs, _agent, _cfg: chunked_step(st, env, bs)
    else:
        step_j = jax.jit(emaml_train_step, static_argnums=(3, 4))

    ckpt = Checkpointer(cfg.checkpoint_dir)
    start = 0
    if resume:
        tmpl = {"params": st.params, "opt_state": st.opt_state,
                "kl_coeffs": st.kl_coeffs, "key": _key_data(key),
                "state_key": _key_data(st.key),
                "tasks_covered": st.tasks_covered,
                "tasks_succeeded": st.tasks_succeeded, "iteration": 0}
        restored = ckpt.restore(tmpl)
        if restored is not None:
            st = st._replace(
                params=restored["params"], opt_state=restored["opt_state"],
                kl_coeffs=restored["kl_coeffs"],
                # the step's own rollout/sampling RNG: without it a
                # resumed run replays iteration 0's exploration noise
                key=_wrap_key(restored["state_key"]),
                tasks_covered=restored["tasks_covered"],
                tasks_succeeded=restored["tasks_succeeded"])
            key = _wrap_key(restored["key"])
            start = int(restored["iteration"]) + 1
            print(f"resumed from iteration {start - 1}", file=sys.stderr)
    n_envs = ecfg.n_tasks * ecfg.envs_per_task
    t_iter = time.perf_counter()
    for i in range(start, cfg.total_iterations):
        # fresh task sampling per meta-iteration (emaml.py:349-361)
        key, kt, kr = jax.random.split(key, 3)
        assign = sample_task_assignment(kt, int(bank.n_tasks), ecfg)
        opts = ResetOptions(
            prob_index=assign, subprob_index=jnp.full_like(assign, -1),
            adaptation=jnp.ones((), bool),
            reset_on_submit=jnp.zeros((), bool))
        env = BatchedEnv(table=table, bank=bank,
                         max_trial=cfg.env.max_trial,
                         episode_limit=cfg.env.episode_limit,
                         auto_reset=True,
                         dense_reward=cfg.env.dense_reward,
                         augment=cfg.env.augment, opts=opts,
                         reset_pool=cfg.env.reset_pool)
        # jitted fused reset (envs/core.py reset_jit): the eager path
        # dispatches its kernels one by one every meta-iteration
        bs = reset_jit(env, kr, n_envs)
        st, bs, metrics = step_j(st, env, bs, agent, ecfg)
        post_batch = metrics.pop("post_batch")
        # wandb schema keys (train.py:130-150)
        logged = {
            "total_loss": metrics["meta_loss"],
            "outer_policy_loss": metrics["outer_policy_loss"],
            "outer_vf_loss": metrics["outer_vf_loss"],
            "outer_kl_loss": metrics["outer_kl_loss"],
            "outer_total_loss": metrics["outer_total_loss"],
            "adapt_eprewmax": metrics["adapt_reward_max"],
            "adapt_eprewmean": metrics["adapt_reward_mean"],
            "adapt_eprewmin": metrics["adapt_reward_min"],
            "post_eprewmax": metrics["post_eprew_max"],
            "post_eprewmean": metrics["post_eprew_mean"],
            "post_eprewmin": metrics["post_eprew_min"],
            "num_covered_tasks": metrics["num_covered_tasks"],
            "num_succeed_tasks": metrics["num_succeed_tasks"],
            "kl": metrics["inner_kl_mean"],
            # per-task arrays (emaml.py:431-454 bookkeeping), in the record
            # so a run log alone reconstructs which tasks were solved
            "sampled_tasks": np.asarray(metrics["sampled_tasks"]).tolist(),
            "once_successful":
                np.asarray(metrics["once_successful"]).astype(int).tolist(),
            "post_reward_per_task":
                np.asarray(metrics["post_reward_per_task"]).tolist(),
        }
        if "unit_times" in metrics:
            logged["unit_times"] = metrics["unit_times"]
        logger.log(i, logged)
        # stderr heartbeat: liveness signal for supervise.py and humans
        now = time.perf_counter()
        print(f"[iter {i}] meta_loss={float(logged['total_loss']):.4f} "
              f"post_eprew={float(logged['post_eprewmean']):.3f} "
              f"({now - t_iter:.1f}s)", file=sys.stderr, flush=True)
        t_iter = now
        # successful-batch persistence (train.py:126-128): pickle the
        # post-adaptation batch of every task that solved this iteration;
        # the device->host transfer only happens on success
        success = np.asarray(metrics["once_successful"])
        if success.any():
            task_ids = np.asarray(metrics["sampled_tasks"])
            sdir = os.path.join(cfg.checkpoint_dir, "successful")
            os.makedirs(sdir, exist_ok=True)
            for ti in np.nonzero(success)[0]:
                b = jax.tree.map(lambda x: np.asarray(x[ti]), post_batch)
                with open(os.path.join(
                        sdir, f"epoch{i}_{int(task_ids[ti])}.pickle"),
                        "wb") as fp:
                    pickle.dump({"task_idx": int(task_ids[ti]),
                                 "batch": b._asdict()}, fp)
        if cfg.checkpoint_every and i % cfg.checkpoint_every == 0:
            ckpt.save(i, {"params": st.params, "opt_state": st.opt_state,
                          "kl_coeffs": st.kl_coeffs, "key": _key_data(key),
                          "state_key": _key_data(st.key),
                          "tasks_covered": st.tasks_covered,
                          "tasks_succeeded": st.tasks_succeeded,
                          "iteration": i})
    return st.params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="emaml", choices=["ppo", "emaml"])
    ap.add_argument("--model", default="mlp", choices=["mlp", "gpt"])
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--n-envs", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="MLP torso compute dtype")
    ap.add_argument("--log-file", default="train_log.jsonl")
    ap.add_argument("--ckpt-dir", default="./ckpts")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes for a quick end-to-end check")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir and "
                         "continue (the RLlib algo.save/from_checkpoint "
                         "counterpart)")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = RunConfig(
            seed=args.seed, algo=args.algo, model=args.model,
            total_iterations=args.iterations, checkpoint_every=1,
            checkpoint_dir=args.ckpt_dir,
            env=EnvConfig(family="o2arc_crop33", max_trial=7,
                          episode_limit=10, n_envs=32,
                          dataset=args.dataset, n_synthetic_tasks=8),
            ppo=PPOConfig(n_epochs=1, n_minibatches=1),
            emaml=EMAMLConfig(n_tasks=2, envs_per_task=4, rollout_steps=10,
                              inner_steps=2, maml_opt_steps=1),
            mlp_hidden=(128, 64), mlp_dtype=args.dtype)
    else:
        cfg = RunConfig(
            seed=args.seed, algo=args.algo, model=args.model,
            total_iterations=args.iterations, checkpoint_dir=args.ckpt_dir,
            env=EnvConfig(family="o2arc_crop33",
                          n_envs=args.n_envs, dataset=args.dataset),
            mlp_dtype=args.dtype)
    print(cfg.to_json(), file=sys.stderr)
    enable_compile_cache()
    logger = MetricLogger(args.log_file)
    log_provenance(logger, cfg, argv)
    if cfg.algo == "ppo":
        run_ppo(cfg, logger, resume=args.resume)
    else:
        run_emaml(cfg, logger, resume=args.resume)


if __name__ == "__main__":
    main()
