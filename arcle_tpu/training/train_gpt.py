"""GPT training driver — counterpart of /root/reference/agents/train_gpt.py.

Same skeleton as the MLP driver but with the transformer policy
(8 layers / 16 heads / 128 embd, train_gpt.py:65-80 == gptconfig.yaml),
the full flattened observation (no FilterO2ARC), and the autoregressive
operation+bbox action head.

Run:  python -m arcle_tpu.training.train_gpt --iterations 100
"""

from __future__ import annotations

import argparse
import sys

from ..models.gpt import GPTConfig
from ..training.ppo import PPOConfig
from ..training.emaml import EMAMLConfig
from ..utils.config import RunConfig, EnvConfig
from ..utils.metrics import MetricLogger
from ..utils.compile_cache import enable_compile_cache
from .train import log_provenance, run_ppo, run_emaml


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="emaml", choices=["ppo", "emaml"])
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--log-file", default="train_gpt_log.jsonl")
    ap.add_argument("--ckpt-dir", default="./ckpts_gpt")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inner-steps", type=int, default=20,
                    help="inner-adaptation steps per task (reference: 20, "
                         "train_gpt.py:54); lower = shorter wall-clock per "
                         "meta-iteration")
    ap.add_argument("--meta-steps", type=int, default=5,
                    help="meta-optimizer steps per iteration (reference: 5)")
    ap.add_argument("--envs-per-task", type=int, default=1,
                    help="lockstep envs per task (reference: 1 env/worker; "
                         "more envs cost almost no extra wall-clock at "
                         "B<=16 on the 1837-token GPT — the forward is "
                         "latency-bound — but multiply the data per "
                         "inner step)")
    ap.add_argument("--rollout-steps", type=int, default=100,
                    help="rollout fragment length (reference: 100); the "
                         "dominant wall-clock term is sequential GPT "
                         "forwards, one per step")
    ap.add_argument("--n-micro", type=int, default=None,
                    help="gradient-accumulation chunks per inner update; "
                         "default keeps ~50-sample micro-batches, which "
                         "bounds the 1837-token fwd+bwd activation memory")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable per-block rematerialization in the GPT "
                         "(faster backward, ~2x activation memory; fits "
                         "at the default micro-batch size)")
    ap.add_argument("--kl-ladder-grads", action="store_true",
                    help="backprop the inner-KL ladder term through its "
                         "own pass (reference MAMLLoss parity); default "
                         "reads the KL value off the surrogate pass and "
                         "drops the ~1e-7-weight gradient term "
                         "(EMAMLConfig.kl_ladder_grads)")
    ap.add_argument("--exact-chain", action="store_true",
                    help="re-replay the FOMAML inner chain at every "
                         "meta-opt step (the reference's higher-replay "
                         "semantics, ~5x the meta-phase FLOPs); default "
                         "caches the chain from the inner-adaptation "
                         "pass and transports deltas "
                         "(EMAMLConfig.cache_chain)")
    ap.add_argument("--aux-coeff", type=float, default=0.0,
                    help="weight of the action-conditioned auxiliary "
                         "losses (r_{t-1}/r_t/next-grid, paper §4.1.1); "
                         "0 = off (shipped-reference parity)")
    args = ap.parse_args(argv)

    # fail fast on statically-known incompatibilities instead of after
    # minutes of rollouts/compiles: the aux losses need aux-target
    # batches, which only the PPO driver builds, and they don't decompose
    # over the E-MAML micro-batch accumulation
    if args.aux_coeff > 0.0 and args.algo != "ppo":
        ap.error("--aux-coeff > 0 requires --algo ppo (E-MAML batches "
                 "carry no aux targets, and aux terms don't decompose "
                 "over n_micro gradient accumulation)")

    gpt = GPTConfig(attn_chunk=256, remat=not args.no_remat) \
        if not args.smoke else GPTConfig(n_layer=2, n_head=4, n_embd=32)
    cfg = RunConfig(
        seed=args.seed, algo=args.algo, model="gpt",
        total_iterations=args.iterations,
        # every iteration: a meta-iteration is minutes of work and the
        # supervisor (training/supervise.py) resumes from the last one
        checkpoint_every=0 if args.smoke else 1,
        checkpoint_dir=args.ckpt_dir,
        env=EnvConfig(family="o2arc_crop33", max_trial=7,
                      episode_limit=10 if args.smoke else 100,
                      n_envs=8 if args.smoke else 64,
                      dataset=args.dataset,
                      n_synthetic_tasks=8 if args.smoke else 32),
        # the 1837-token transformer needs minibatched updates (64 samples
        # per minibatch over the 6400-sample batch)
        ppo=PPOConfig(n_epochs=1,
                      n_minibatches=1 if args.smoke else 100,
                      vf_coeff=0.5,       # train_gpt.py:61 (GPT uses 0.5)
                      aux_coeff=args.aux_coeff),
        # full reference envelope (train_gpt.py:47-55): 2 workers x
        # (1 env x 100-step rollouts) = batch 100 per task per inner step,
        # 20 inner / 5 meta steps; first_order (FOMAML) keeps the
        # 20-step replay through the 8L/16H/128E transformer on-chip
        emaml=EMAMLConfig(
            n_tasks=2,
            envs_per_task=4 if args.smoke else args.envs_per_task,
            rollout_steps=10 if args.smoke else args.rollout_steps,
            inner_steps=1 if args.smoke else args.inner_steps,
            maml_opt_steps=1 if args.smoke else args.meta_steps,
            first_order=True,
            # 25-sample micro-batches bound the replay's activation
            # memory (see EMAMLConfig.n_micro)
            n_micro=1 if args.smoke else (
                args.n_micro if args.n_micro
                else max(2, (args.envs_per_task * args.rollout_steps)
                         // 50)),
            kl_ladder_grads=args.smoke or args.kl_ladder_grads,
            # host-chunked step: short jitted units instead of one fused
            # multi-minute program (see make_chunked_train_step)
            chunked=not args.smoke,
            cache_chain=not args.smoke and not args.exact_chain,
            ppo=PPOConfig(vf_coeff=0.5, aux_coeff=args.aux_coeff)),
        gpt=gpt,
        # GPT PPO: split rollout|update jits (RunConfig.ppo_chunked)
        ppo_chunked=not args.smoke)
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
