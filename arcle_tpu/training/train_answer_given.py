"""Driver for the paper §4.1 answer-given benchmark.

Reproduces the reference's published headline experiments
(arcle_paper.pdf §4.1.1-§4.1.3, the baselines recorded in BASELINE.md):
PPO over thousands of lockstep 5x5 answer-given envs, with the
color-equivariant policy and the three auxiliary losses.

Experiment cells::

    # headline (Figure 5, rightmost curve): all three aux losses
    python -m arcle_tpu.training.train_answer_given --aux all

    # vanilla PPO control ("not able to learn anything")
    python -m arcle_tpu.training.train_answer_given --aux none

    # architecture control (Figure 6): non-sequential factorized policy
    python -m arcle_tpu.training.train_answer_given --arch nonseq

    # continual setting (Figure 7): colors 2 -> 4 -> 6 -> 8 -> 10
    python -m arcle_tpu.training.train_answer_given --continual

Success rate is measured per completed episode (solved episodes / finished
episodes within the rollout window); the paper's target is >95% in the
random setting.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import jax
import jax.numpy as jnp

from ..benchmarks.answer_given import (
    answer_given_agent, answer_given_env, make_policy, shaping_potential,
)
from ..envs.core import reset_jit
from ..utils.checkpoint import Checkpointer
from ..utils.metrics import MetricLogger, Throughput
from .ppo import PPOConfig, batch_from_trajectory, make_optimizer, train_step
from .rollout import rollout
from ..utils.compile_cache import enable_compile_cache
from .train import _key_data, _wrap_key


def build(args):
    env = answer_given_env(
        n_tasks=args.n_tasks, h=args.size, w=args.size,
        colors=args.colors, seed=args.seed,
        episode_limit=args.episode_limit, setting=args.setting)
    policy = make_policy(
        h=args.size, w=args.size, colors=args.colors,
        n_layer=args.n_layer, n_head=args.n_head, n_embd=args.n_embd,
        factorized=(args.arch == "nonseq"),
        color_equivariant=(args.arch == "color_eq"),
        bbox_dist_kind=args.bbox_dist)
    agent = answer_given_agent(policy, min_log_std=args.min_log_std,
                               sequential=(args.arch == "sequential"))
    pcfg = PPOConfig(
        gamma=args.gamma, gae_lambda=args.gae_lambda,
        clip_eps=args.clip, vf_clip=10.0, vf_coeff=args.vf_coeff,
        entropy_coeff=args.ent_coeff, kl_coeff=0.0, lr=args.lr,
        n_epochs=args.epochs, n_minibatches=args.minibatches,
        max_grad_norm=1.0,
        aux_coeff=0.0 if args.aux == "none" else args.aux_coeff,
        aux_terms="all" if args.aux == "none" else args.aux)
    return env, agent, pcfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--setting", default="random", choices=["random", "arc"])
    ap.add_argument("--size", type=int, default=5)
    ap.add_argument("--colors", type=int, default=10)
    ap.add_argument("--n-tasks", type=int, default=16384)
    ap.add_argument("--episode-limit", type=int, default=50)
    ap.add_argument("--arch", default="color_eq",
                    choices=["color_eq", "nonseq", "sequential"])
    ap.add_argument("--aux", default="all",
                    choices=["none", "rtm1", "rtm1+rt", "all"])
    ap.add_argument("--aux-coeff", type=float, default=0.3)
    ap.add_argument("--n-layer", type=int, default=4)
    ap.add_argument("--n-head", type=int, default=4)
    ap.add_argument("--n-embd", type=int, default=128)
    ap.add_argument("--n-envs", type=int, default=1024)
    ap.add_argument("--rollout", type=int, default=64)
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--gamma", type=float, default=0.95)
    ap.add_argument("--potential-shaping", action="store_true",
                    default=True,
                    help="learner-side potential-based shaping with "
                         "phi(s) = -wrong/total (policy-invariant; env "
                         "reward and metrics stay the paper's)")
    ap.add_argument("--no-potential-shaping", dest="potential_shaping",
                    action="store_false")
    ap.add_argument("--bbox-dist", default="categorical",
                    choices=["categorical", "truncnorm"],
                    help="selection head: discrete per-coordinate "
                         "categorical (default) or the reference's "
                         "TruncatedNormal AROPandBBox parameterization")
    ap.add_argument("--min-log-std", type=float, default=-2.3,
                    help="floor on the bbox log-std (exploration keeps a "
                         "~0.1 noise floor on the [0,1] coords); -20 "
                         "restores reference-parity behavior")
    ap.add_argument("--gae-lambda", type=float, default=0.95)
    ap.add_argument("--clip", type=float, default=0.2)
    ap.add_argument("--vf-coeff", type=float, default=0.5)
    ap.add_argument("--ent-coeff", type=float, default=0.01,
                    help="final entropy bonus (after annealing)")
    ap.add_argument("--ent-coeff-start", type=float, default=0.1,
                    help="initial entropy bonus during the discovery "
                         "phase (keeps the selection heads diffuse so "
                         "precise single-cell actions keep occurring)")
    ap.add_argument("--ent-anneal-iters", type=int, default=1500,
                    help="iterations to anneal ent-coeff-start -> "
                         "ent-coeff; 0 = constant --ent-coeff")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continual", action="store_true",
                    help="§4.1.3 continual setting: 5 phases with "
                         "2/4/6/8/10 colors (--phase-iters each)")
    ap.add_argument("--phase-iters", type=int, default=400)
    ap.add_argument("--log-file", default="answer_given_log.jsonl")
    ap.add_argument("--ckpt-dir", default="./ckpts_answer_given")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    enable_compile_cache()
    logger = MetricLogger(args.log_file)
    # provenance header so a committed log is interpretable later
    # (config, argv, git sha) — advisor round-3 finding
    try:
        import subprocess
        proc = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True, timeout=5)
        sha = proc.stdout.strip()
        if proc.returncode != 0 or not sha:
            sha = "unknown"
    except Exception:
        sha = "unknown"
    logger.log(-1, {"_meta": True, "argv": list(argv or sys.argv[1:]),
                    "config": {k: v for k, v in vars(args).items()},
                    "git_sha": sha})
    env, agent, pcfg = build(args)

    banks = None
    if args.continual:
        # §4.1.3: randomly generated as before but the color count
        # increases across five phases; same 10-op action space.  Banks
        # share shapes, so phase switches recompile nothing.
        from ..benchmarks.answer_given import RandomPairLoader
        banks = [RandomPairLoader(args.n_tasks, args.size, args.size,
                                  c, args.seed + 100 + c).bank(
                     H=args.size, W=args.size)
                 for c in (2, 4, 6, 8, 10)]
        args.iterations = args.phase_iters * len(banks)

    key = jax.random.key(args.seed)
    key, ki, kr = jax.random.split(key, 3)
    bs = reset_jit(env, kr, args.n_envs)
    params = agent.init_fn(ki, agent.obs_fn(
        jax.tree.map(lambda x: x[:1], bs.env)))
    n_params = sum(x.size for x in jax.tree.leaves(params))
    print(f"policy params: {n_params:,}", file=sys.stderr)
    tx = make_optimizer(pcfg)
    opt_state = tx.init(params)

    include_aux = pcfg.aux_coeff > 0.0
    T = args.rollout
    P = args.size * args.size
    gslice = slice(0, P)   # grid cells lead the answer-given obs layout

    def iteration(env, bs, params, opt_state, key, ent_coeff):
        key, kroll, ktrain = jax.random.split(key, 3)
        bs, traj, last_v = rollout(env, bs, params, kroll, T, agent)
        learn_traj = traj
        if args.potential_shaping:
            # Policy-invariant potential shaping (Ng et al. 1999) with
            # phi(s) = -(wrong cells inside answer_dim)/(answer area) —
            # the learner's reward becomes the per-step *change* in
            # wrongness plus a terminal solve bonus, so a precise fix
            # earns positive advantage while a harmless repaint earns ~0.
            # The env reward, the logged metrics, and the aux-loss targets
            # below stay the paper's raw reward.
            # phi must be computed over the SAME cells as pixel_reward
            # (ops/table.py pixel_reward: inside answer_dim only) so that
            # phi(s_{t+1}) == r_t exactly and the telescoping identity
            #   r'_t = r_t + gamma*phi(s_{t+1})*(1-term) - phi(s_t)
            # holds.  (In the ARC setting dims can be < size x size; an
            # all-cells phi here would NOT be potential-based and biases
            # small tasks — the round-3 ARC run's regression.)
            phi_t = shaping_potential(traj.obs, args.size, args.size)
            term_f = traj.terminated.astype(jnp.float32)
            shaped = (traj.rewards * (1.0 + pcfg.gamma * (1.0 - term_f))
                      - phi_t)
            learn_traj = traj._replace(rewards=shaped)
        batch = batch_from_trajectory(learn_traj, last_v, pcfg,
                                      include_aux=include_aux,
                                      grid_slice=gslice)
        if args.potential_shaping and include_aux:
            # aux heads still predict the *raw* §4.1 reward
            flat = lambda x: x.reshape((-1,) + x.shape[2:])
            raw_prev = jnp.concatenate(
                [jnp.zeros_like(traj.rewards[:1]),
                 traj.rewards[:-1] * (1.0 - traj.dones[:-1])], axis=0)
            batch = batch._replace(rewards=flat(traj.rewards),
                                   prev_rewards=flat(raw_prev))
        n_done = traj.dones.sum()
        n_solved = traj.terminated.sum()
        extras = {
            # per-episode statistics over episodes finishing in the window
            "success_rate": n_solved / jnp.maximum(n_done, 1),
            "episode_reward_mean":
                traj.rewards.sum() / jnp.maximum(n_done, 1),
            "episode_len_mean":
                (traj.rewards.size / jnp.maximum(n_done, 1)),
            "episodes": n_done,
        }
        params, opt_state, stats = train_step(
            params, opt_state, batch, ktrain, agent, tx, pcfg, ent_coeff)
        stats = dict(stats)
        stats.update(extras)
        return bs, params, opt_state, key, stats

    it_j = jax.jit(iteration)

    def ent_schedule(i):
        """Annealed exploration: hold --ent-coeff-start for the discovery
        phase, then decay linearly to --ent-coeff by --ent-anneal-iters
        (a traced scalar — no recompiles across the schedule)."""
        if args.ent_anneal_iters <= 0:
            return jnp.asarray(args.ent_coeff, jnp.float32)
        frac = min(max(i / args.ent_anneal_iters, 0.0), 1.0)
        v = args.ent_coeff_start + (args.ent_coeff
                                    - args.ent_coeff_start) * frac
        return jnp.asarray(v, jnp.float32)
    ckpt = Checkpointer(args.ckpt_dir)
    start = 0
    if args.resume:
        tmpl = {"params": params, "opt_state": opt_state,
                "key": _key_data(key), "iteration": 0}
        restored = ckpt.restore(tmpl)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt_state"]
            key = _wrap_key(restored["key"])
            start = int(restored["iteration"]) + 1
            print(f"resumed from iteration {start - 1}", file=sys.stderr)

    thr = Throughput()
    t0 = time.perf_counter()
    phase = -1
    for i in range(start, args.iterations):
        if banks is not None:
            p = min(i // args.phase_iters, len(banks) - 1)
            if p != phase:
                phase = p
                env = dataclasses.replace(env, bank=banks[p])
                key, kr = jax.random.split(key)
                bs = reset_jit(env, kr, args.n_envs)
                print(f"[phase {p}] colors={2 * (p + 1)}", file=sys.stderr)
        bs, params, opt_state, key, stats = it_j(env, bs, params,
                                                 opt_state, key,
                                                 ent_schedule(i))
        rate = thr.tick(args.n_envs * T, stats)
        out = {k: float(v) for k, v in stats.items()}
        out["env_steps_per_s"] = rate
        if banks is not None:
            out["phase"] = phase
        logger.log(i, out)
        if i % 10 == 0:
            print(f"[iter {i}] success={out['success_rate']:.3f} "
                  f"eprew={out['episode_reward_mean']:.2f} "
                  f"loss={out['total_loss']:.4f} {rate:,.0f} steps/s "
                  f"({time.perf_counter() - t0:.0f}s)",
                  file=sys.stderr, flush=True)
        if args.ckpt_every and i % args.ckpt_every == 0:
            ckpt.save(i, {"params": params, "opt_state": opt_state,
                          "key": _key_data(key), "iteration": i})
    return params


if __name__ == "__main__":
    main()
