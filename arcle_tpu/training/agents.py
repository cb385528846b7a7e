"""Policy-agnostic agent interface for the rollout/PPO/E-MAML machinery.

An :class:`Agent` packages three pure functions over a flat observation
vector, so the learners never care which network family is behind them:

* ``obs_fn(env_state) -> obs``             batched observation builder
* ``sample_fn(params, obs, key, det) -> (actions[...,5], log_prob, value)``
* ``evaluate_fn(params, obs, actions) -> (log_prob, value, entropy)``

Two factories mirror the reference's two training paths:

* :func:`mlp_agent` — FilterO2ARC+Flatten obs, multi-categorical 5-tuple
  heads (the train.py MLP pipeline, train.py:62-68).
* :func:`gpt_agent` — full flattened obs, transformer forward, categorical
  op + truncated-normal bbox autoregressive head (train_gpt.py +
  bboxdist.py).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable

import jax
import jax.numpy as jnp

from ..models.mlp import (
    FCPolicy, multi_categorical_sample, multi_categorical_log_prob,
    multi_categorical_entropy, stack_padded_logits,
)
from ..models import bbox_dist
from ..wrappers import flatten_obs, full_flatten_obs, unflatten_full, \
    FULL_OBS_DIM

if TYPE_CHECKING:   # the transformer needs flax; the MLP path does not
    from ..models.gpt import GPTPolicy


@dataclasses.dataclass(frozen=True)
class Agent:
    obs_fn: Callable
    sample_fn: Callable
    evaluate_fn: Callable
    init_fn: Callable          # (key, example_obs) -> params
    obs_dim: int
    # optional action-conditioned auxiliary predictions
    # (params, obs, actions) -> {"rtm1", "r", "g_logits"}; used by
    # ppo_loss when aux_coeff > 0 (paper §4.1.1 losses)
    aux_fn: Callable = None


def mlp_agent(policy: FCPolicy) -> Agent:
    def sample_fn(params, obs, key, deterministic=False):
        logits_tuple, value = policy.apply(params, obs)
        if deterministic:
            acts = jnp.argmax(stack_padded_logits(logits_tuple),
                              -1).astype(jnp.int32)
            lp = multi_categorical_log_prob(logits_tuple, acts)
        else:
            acts, lp = multi_categorical_sample(key, logits_tuple)
        return acts, lp, value

    def evaluate_fn(params, obs, actions):
        logits_tuple, value = policy.apply(params, obs)
        lp = multi_categorical_log_prob(logits_tuple, actions)
        ent = multi_categorical_entropy(logits_tuple)
        return lp, value, ent

    return Agent(obs_fn=flatten_obs, sample_fn=sample_fn,
                 evaluate_fn=evaluate_fn,
                 init_fn=lambda key, obs: policy.init(key, obs),
                 obs_dim=2710)


def _gpt_forward(model: GPTPolicy, params, obs):
    f = unflatten_full(obs)
    return model.apply(params, f["grid"].astype(jnp.int8), f["grid_dim"],
                       f["input"].astype(jnp.int8), f["input_dim"],
                       f["trials_remain"], f["active"])


def gpt_agent(model: GPTPolicy, grid_size: int = 30) -> Agent:
    """The op+bbox distribution math lives in :mod:`models.bbox_dist`
    (single source of truth, AROPandBBox parity)."""

    def sample_fn(params, obs, key, deterministic=False):
        out = _gpt_forward(model, params, obs)
        s = bbox_dist.sample(key, out["op_logits"], out["bbox_mean_all"],
                             out["bbox_std_all"], grid_size, deterministic)
        acts = jnp.concatenate(
            [s.bbox, s.operation[..., None].astype(jnp.int32)], -1)
        return acts, s.log_prob, out["value"]

    def evaluate_fn(params, obs, actions):
        out = _gpt_forward(model, params, obs)
        op = actions[..., 4]
        lp = bbox_dist.log_prob(out["op_logits"], out["bbox_mean_all"],
                                out["bbox_std_all"], op, actions[..., :4],
                                grid_size)
        ent = bbox_dist.entropy(out["op_logits"], out["bbox_mean_all"],
                                out["bbox_std_all"], op)
        return lp, out["value"], ent

    def aux_fn(params, obs, actions):
        """Second, action-conditioned forward (GPTPolicy.py:401-456
        intent): append the op embedding + Periodic bbox tokens and read
        r_t / next-grid predictions.  rtm1 is read from this pass's CLS
        (the reference reads it from a separate unconditioned pass —
        GPTPolicy.py:432-434 — but r_{t-1} is pre-action information, so
        conditioning is harmless and saves a third forward)."""
        f = unflatten_full(obs)
        out = model.apply(params, f["grid"].astype(jnp.int8), f["grid_dim"],
                          f["input"].astype(jnp.int8), f["input_dim"],
                          f["trials_remain"], f["active"],
                          operation=actions[..., 4].astype(jnp.int32),
                          bbox=actions[..., :4].astype(jnp.float32)
                          / grid_size)
        return {"rtm1": out["aux_rtm1"], "r": out["aux_reward"],
                "g_logits": out["aux_transition"]}

    def init_fn(key, obs):
        f = unflatten_full(obs)
        return model.init(key, f["grid"].astype(jnp.int8), f["grid_dim"],
                          f["input"].astype(jnp.int8), f["input_dim"],
                          f["trials_remain"], f["active"])

    return Agent(obs_fn=full_flatten_obs, sample_fn=sample_fn,
                 evaluate_fn=evaluate_fn, init_fn=init_fn,
                 obs_dim=FULL_OBS_DIM, aux_fn=aux_fn)
