"""PPO learner (optax), sharded-data-parallel ready.

The loss mirrors the reference's functional ``PPOLoss``
(/root/reference/agents/emaml_policy.py:38-99): clipped surrogate +
clipped value loss + entropy bonus + KL penalty against the behavior
policy.  Gradient sync across a device mesh happens automatically when the
train step is jitted with the batch sharded and params replicated — the
batched counterpart of the reference's single-GPU learn_on_batch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from .rollout import Trajectory, gae


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters; defaults follow the reference EMAMLConfig / drivers
    (train.py:43-59, emaml.py:161-280)."""

    gamma: float = 0.9
    gae_lambda: float = 1.0
    clip_eps: float = 0.3        # clip_param (emaml.py:122)
    vf_clip: float = 10.0        # vf_clip_param (emaml.py:123)
    vf_coeff: float = 0.1        # vf_loss_coeff (train.py:56)
    entropy_coeff: float = 0.0   # (emaml.py:121)
    kl_coeff: float = 0.0005
    lr: float = 1e-4
    n_epochs: int = 1
    n_minibatches: int = 1
    max_grad_norm: float = 10.0  # grad_clip (train.py:58); 0 = off
    bootstrap_truncation: bool = True  # TimeLimit GAE bootstrap (RLlib
                                 # Postprocessing semantics); False =
                                 # treat truncation as termination
    aux_coeff: float = 0.0       # weight of the GPT auxiliary losses
                                 # (r_{t-1}/r_t/next-grid, paper §4.1.1);
                                 # 0 = off, matching the shipped reference
                                 # whose aux heads never enter its loss
    aux_terms: str = "all"       # which aux terms enter the loss — the
                                 # paper's Figure-5 ablation ladder:
                                 # "rtm1" | "rtm1+rt" | "all"


class PPOBatch(NamedTuple):
    obs: jax.Array        # [N, D]
    actions: jax.Array    # [N, 5]
    log_probs: jax.Array  # [N]
    values: jax.Array     # [N]
    advantages: jax.Array # [N]
    returns: jax.Array    # [N]
    # aux-loss targets (None unless built with include_aux; paper §4.1.1)
    rewards: jax.Array = None       # [N]    r_t
    prev_rewards: jax.Array = None  # [N]    r_{t-1} (0 at episode starts)
    next_grid: jax.Array = None     # [N, 900] i8 next-state grid cells
    aux_valid: jax.Array = None     # [N] f32 1 where next_grid is in-episode


def batch_from_trajectory(traj: Trajectory, last_value: jax.Array,
                          cfg: PPOConfig,
                          include_aux: bool = False,
                          grid_slice: slice = slice(902, 1802)) -> PPOBatch:
    """``include_aux`` adds the targets for the GPT auxiliary predictions:
    r_t, r_{t-1} (zeroed across episode boundaries) and the next
    observation's grid cells (``grid_slice`` is the grid field's offsets
    in the flattened obs — 902:1802 in the full 16-field layout)."""
    adv, ret = gae(traj, last_value, cfg.gamma, cfg.gae_lambda,
                   cfg.bootstrap_truncation)
    adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    aux = {}
    if include_aux:
        T = traj.rewards.shape[0]
        prev_r = jnp.concatenate(
            [jnp.zeros_like(traj.rewards[:1]),
             traj.rewards[:-1] * (1.0 - traj.dones[:-1])], axis=0)
        # next obs within the rollout; the step after a done belongs to a
        # fresh episode, and the last step has no successor stored
        nxt = jnp.concatenate(
            [traj.obs[1:, :, grid_slice], traj.obs[-1:, :, grid_slice]],
            axis=0)
        valid = jnp.concatenate(
            [1.0 - traj.dones[:-1].astype(jnp.float32),
             jnp.zeros_like(traj.rewards[-1:])], axis=0)
        aux = dict(rewards=flat(traj.rewards), prev_rewards=flat(prev_r),
                   next_grid=flat(nxt), aux_valid=flat(valid))
    return PPOBatch(obs=flat(traj.obs), actions=flat(traj.actions),
                    log_probs=flat(traj.log_probs), values=flat(traj.values),
                    advantages=flat(adv_n), returns=flat(ret), **aux)


def ppo_loss(params, agent, batch: PPOBatch, cfg: PPOConfig,
             ent_coeff=None):
    """Clipped PPO loss (emaml_policy.py:38-99).

    ``ent_coeff`` optionally overrides ``cfg.entropy_coeff`` with a
    *traced* scalar so drivers can anneal the entropy bonus without
    recompiling (the answer-given benchmark's exploration schedule)."""
    lp, value, entropy_arr = agent.evaluate_fn(params, batch.obs,
                                               batch.actions)
    ratio = jnp.exp(lp - batch.log_probs)
    surr = jnp.minimum(
        ratio * batch.advantages,
        jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps)
        * batch.advantages)
    policy_loss = -surr.mean()

    vf_err = (value - batch.returns) ** 2
    vf_clipped = (batch.values
                  + jnp.clip(value - batch.values, -cfg.vf_clip, cfg.vf_clip)
                  - batch.returns) ** 2
    vf_loss = 0.5 * jnp.maximum(vf_err, vf_clipped).mean()

    entropy = entropy_arr.mean()
    approx_kl = (batch.log_probs - lp).mean()

    if ent_coeff is None:
        ent_coeff = cfg.entropy_coeff
    total = (policy_loss + cfg.vf_coeff * vf_loss
             - ent_coeff * entropy + cfg.kl_coeff * approx_kl)
    stats = {"policy_loss": policy_loss, "vf_loss": vf_loss,
             "entropy": entropy, "kl": approx_kl}

    if cfg.aux_coeff > 0.0 and getattr(agent, "aux_fn", None) is not None:
        # auxiliary predictions (paper §4.1.1): r_{t-1} from the
        # unconditioned pass, r_t and next-grid from the action-conditioned
        # second pass
        aux = agent.aux_fn(params, batch.obs, batch.actions)
        rtm1_loss = ((aux["rtm1"] - batch.prev_rewards) ** 2).mean()
        r_loss = ((aux["r"] - batch.rewards) ** 2).mean()
        g_logp = jax.nn.log_softmax(aux["g_logits"], axis=-1)
        tgt = jnp.clip(batch.next_grid.astype(jnp.int32), 0,
                       g_logp.shape[-1] - 1)
        classes = jax.lax.broadcasted_iota(jnp.int32,
                                           (g_logp.shape[-1],), 0)
        ce = -jnp.sum(g_logp * (tgt[..., None] == classes), axis=-1)
        denom = jnp.maximum(batch.aux_valid.sum(), 1.0)
        g_loss = (ce.mean(-1) * batch.aux_valid).sum() / denom
        aux_loss = rtm1_loss
        if cfg.aux_terms in ("rtm1+rt", "all"):
            aux_loss = aux_loss + r_loss
        if cfg.aux_terms == "all":
            aux_loss = aux_loss + g_loss
        total = total + cfg.aux_coeff * aux_loss
        stats.update({"aux_loss": aux_loss, "aux_rtm1_loss": rtm1_loss,
                      "aux_r_loss": r_loss, "aux_grid_loss": g_loss})

    stats["total_loss"] = total
    return total, stats


def surrogate_loss(params, agent, batch: PPOBatch, cfg: PPOConfig):
    """The *unclipped* inner-loop surrogate (WorkerLoss,
    emaml_policy.py:101-137): plain importance-weighted advantage +
    value error; used for E-MAML inner adaptation steps."""
    lp, value, _ = agent.evaluate_fn(params, batch.obs, batch.actions)
    ratio = jnp.exp(lp - batch.log_probs)
    policy_loss = -(ratio * batch.advantages).mean()
    vf_loss = 0.5 * ((value - batch.returns) ** 2).mean()
    return policy_loss + cfg.vf_coeff * vf_loss


def make_optimizer(cfg: PPOConfig) -> optax.GradientTransformation:
    tx = [optax.adam(cfg.lr)]
    if cfg.max_grad_norm > 0:
        tx.insert(0, optax.clip_by_global_norm(cfg.max_grad_norm))
    return optax.chain(*tx)


def train_step(params, opt_state, batch: PPOBatch, key: jax.Array,
               agent, tx: optax.GradientTransformation,
               cfg: PPOConfig, ent_coeff=None):
    """n_epochs x n_minibatches PPO updates on one batch (pure)."""
    n = batch.obs.shape[0]
    mb = max(1, n // cfg.n_minibatches)

    if cfg.n_epochs == 1 and cfg.n_minibatches == 1:
        # single full-batch update: the shuffle permutation would be a
        # pure-overhead gather over the whole [N, D] batch (~1 GB at
        # N=400k) — skip it, the update is order-invariant
        (loss, stats), grads = jax.value_and_grad(
            ppo_loss, has_aux=True)(params, agent, batch, cfg, ent_coeff)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, stats

    def epoch(carry, ek):
        params, opt_state = carry
        perm = jax.random.permutation(ek, n)
        shuf = jax.tree.map(lambda x: x[perm], batch)

        def minibatch(carry, i):
            params, opt_state = carry
            sl = jax.tree.map(
                lambda x: jax.lax.dynamic_slice_in_dim(x, i * mb, mb, 0),
                shuf)
            (loss, stats), grads = jax.value_and_grad(
                ppo_loss, has_aux=True)(params, agent, sl, cfg, ent_coeff)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), stats

        (params, opt_state), stats = jax.lax.scan(
            minibatch, (params, opt_state),
            jnp.arange(cfg.n_minibatches))
        return (params, opt_state), jax.tree.map(jnp.mean, stats)

    keys = jax.random.split(key, cfg.n_epochs)
    (params, opt_state), stats = jax.lax.scan(
        epoch, (params, opt_state), keys)
    return params, opt_state, jax.tree.map(jnp.mean, stats)
