"""Batched usage: 1024 lockstep envs under jit (no reference
counterpart -- this is the new engine's main surface)."""
import jax, jax.numpy as jnp, numpy as np
from arcle_tpu.envs import BatchedEnv
from arcle_tpu.loaders import SyntheticLoader
from arcle_tpu.ops import o2arc_table
from arcle_tpu.core.state import Action

env = BatchedEnv(table=o2arc_table(max_trial=3),
                 bank=SyntheticLoader(16).bank(),
                 max_trial=3, episode_limit=100, auto_reset=True)
B = 1024
bs = env.reset(jax.random.key(0), B)
step = jax.jit(type(env).step)
rng = np.random.default_rng(0)
for t in range(20):
    act = Action(
        selection=jnp.asarray(rng.integers(0, 2, (B, 30, 30)).astype(np.int8)),
        operation=jnp.asarray(rng.integers(0, 35, (B,)), jnp.int32))
    bs, obs, rew, term, trunc = step(env, bs, act)
print("total reward:", float(rew.sum()))
