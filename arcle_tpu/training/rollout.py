"""On-device trajectory collection.

The on-device answer to the reference's Ray RolloutWorker sampling loop
(emaml.py:367-401 -> RolloutWorker -> env.step): a ``lax.scan`` over T
lockstep steps of a :class:`BatchedEnv`, with the policy applied on device
and actions decoded through the bbox wrapper — no host round-trips inside
an iteration.  Env, params and keys ride through jit as arguments.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.state import Action
from ..core.geometry import bbox_selection
from ..envs.core import BatchedEnv, BatchedState, flatten_grids, \
    make_reset_pool, unflatten_grids


class Trajectory(NamedTuple):
    """Time-major rollout storage ([T, B, ...])."""

    obs: jax.Array        # f32 [T, B, D]    flattened FilterO2ARC obs
    actions: jax.Array    # i32 [T, B, 5]    (x1, y1, x2, y2, op)
    log_probs: jax.Array  # f32 [T, B]
    values: jax.Array     # f32 [T, B]
    rewards: jax.Array    # f32 [T, B]
    dones: jax.Array      # bool [T, B]      terminated | truncated
    terminated: jax.Array # bool [T, B]      true terminations (solves /
                          # trial exhaustion); GAE bootstraps truncated-
                          # but-not-terminated boundaries with final_values
    final_values: jax.Array  # f32 [T, B]   V(pre-reset obs) where truncated
                          # & not terminated, else 0 — the TimeLimit
                          # bootstrap of the reference's GAE postprocessing
                          # (emaml_policy.py:449-460)


def decode_bbox_actions(actions: jax.Array, H: int = 30,
                        W: int = 30) -> Action:
    """[B,5] ints -> selection-mask Action (BBoxWrapper semantics)."""
    return Action(
        selection=jax.vmap(bbox_selection,
                           in_axes=(0, 0, 0, 0, None, None))(
            actions[:, 0], actions[:, 1], actions[:, 2], actions[:, 3], H, W),
        operation=actions[:, 4],
    )


def rollout(env: BatchedEnv, bs: BatchedState, params, key: jax.Array,
            n_steps: int, agent,
            deterministic: bool = False) -> Tuple[BatchedState, Trajectory, jax.Array]:
    """Collect ``n_steps`` of experience with an :class:`Agent`;
    returns (carry, traj, last_value)."""

    # grid geometry comes from the task bank (5x5 for the answer-given
    # benchmark, 30x30 for the ARC families)
    H, W = env.bank.in_grids.shape[-2:]

    # refresh the auto-reset pool once per rollout: fresh augmentations
    # drawn in one bandwidth-bound batch instead of ~45 launch-bound
    # kernels inside the scan's reset branch (see envs.core.ResetPool)
    if env.auto_reset and env.reset_pool > 0:
        key, kp = jax.random.split(key)
        bs = dataclasses.replace(
            bs, pool=make_reset_pool(env, kp, bs.batch))

    def body(carry, _):
        bs_flat, key = carry
        key, ka = jax.random.split(key)
        bs = unflatten_grids(bs_flat, H, W)
        with jax.named_scope("policy"):
            obs = agent.obs_fn(bs.env)
            acts, lp, value = agent.sample_fn(params, obs, ka, deterministic)
        bs2, obs_env, rew, term, trunc = env.step(
            bs, decode_bbox_actions(acts, H, W))
        next_carry = flatten_grids(bs2, H, W)

        # TimeLimit bootstrap value: V of the *pre-reset* observation
        # (obs_env), needed only where an episode was truncated without
        # terminating.  Behind a batch-level cond, so the extra policy
        # forward runs only on steps where some env actually hit the
        # limit (~1/episode_limit of steps in the lockstep schedule).
        need = trunc & ~term

        def compute_fv(_):
            _, v_fin, _ = agent.evaluate_fn(params, agent.obs_fn(obs_env),
                                            acts)
            return v_fin

        fv = jax.lax.cond(jnp.any(need), compute_fv,
                          lambda _: jnp.zeros_like(value), None)
        fv = jnp.where(need, fv, 0.0)

        out = Trajectory(obs=obs, actions=acts, log_probs=lp, values=value,
                         rewards=rew, dones=term | trunc, terminated=term,
                         final_values=fv)
        return (next_carry, key), out

    (bs_flat, key), traj = jax.lax.scan(
        body, (flatten_grids(bs, H, W), key), None, length=n_steps)
    bs = unflatten_grids(bs_flat, H, W)
    last_obs = agent.obs_fn(bs.env)
    zero_act = jnp.zeros(last_obs.shape[:-1] + (5,), jnp.int32)
    _, last_value, _ = agent.evaluate_fn(params, last_obs, zero_act)
    return bs, traj, last_value


def gae(traj: Trajectory, last_value: jax.Array, gamma: float,
        lam: float, bootstrap_truncation: bool = True
        ) -> Tuple[jax.Array, jax.Array]:
    """Generalized advantage estimation over time-major trajectories
    (the reference's RLlib GAE postprocessing, emaml_policy.py:449-460).

    With in-graph auto-reset the observation after a ``done`` belongs to a
    fresh episode, so the advantage recursion is cut at *any* episode
    boundary; truncated-but-not-terminated boundaries bootstrap their final
    delta with ``traj.final_values`` — V of the pre-reset observation —
    matching the reference's TimeLimit handling
    (Postprocessing/compute_gae_for_sample_batch via emaml_policy.py:449-460).
    ``bootstrap_truncation=False`` restores the treat-truncation-as-
    termination simplification (the round-1 semantics).
    """
    fv = traj.final_values if bootstrap_truncation \
        else jnp.zeros_like(traj.values)

    def body(carry, xs):
        adv_next, v_next = carry
        value, reward, done, fval = xs
        noncut = 1.0 - done.astype(jnp.float32)
        # at a truncation fval = V(pre-reset obs) and noncut = 0: the delta
        # bootstraps while the advantage chain still cuts
        delta = reward + gamma * (v_next * noncut + fval) - value
        adv = delta + gamma * lam * noncut * adv_next
        return (adv, value), adv

    (_, _), advs = jax.lax.scan(
        body, (jnp.zeros_like(last_value), last_value),
        (traj.values, traj.rewards, traj.dones, fv),
        reverse=True)
    returns = advs + traj.values
    return advs, returns
