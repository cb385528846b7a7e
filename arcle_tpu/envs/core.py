"""Functional environment cores.

``reset``/``step`` as pure functions over :class:`EnvState`, with task
selection happening *on device* from a :class:`TaskBank` — the batched
counterpart of the reference's ``AbstractARCEnv.reset`` task plumbing
(base.py:69-118).  Randomness uses explicit ``jax.random`` keys instead of
the reference's global-numpy-RNG calls (base.py:99,104 / loader.py:51) — a
documented divergence; parity tests pin explicit indices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.state import EnvState, Action, init_state, I8, I32
from ..loaders.loader import TaskBank
from ..ops.table import (
    OpTable, step as _step, transition as _transition,
    step_deferred as _step_deferred, finish_flood as _finish_flood,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ResetOptions:
    """Dynamic reset options (the reference's ``options`` dict,
    base.py:87-93).  Negative index = sample uniformly with the key."""

    prob_index: jax.Array      # i32 [] ; -1 -> sample
    subprob_index: jax.Array   # i32 [] ; -1 -> sample
    adaptation: jax.Array      # bool []
    reset_on_submit: jax.Array # bool []

    @staticmethod
    def make(prob_index: int = -1, subprob_index: int = -1,
             adaptation: bool = True,
             reset_on_submit: bool = False) -> "ResetOptions":
        return ResetOptions(
            prob_index=jnp.asarray(prob_index, I32),
            subprob_index=jnp.asarray(subprob_index, I32),
            adaptation=jnp.asarray(adaptation, bool),
            reset_on_submit=jnp.asarray(reset_on_submit, bool),
        )


def reset(bank: TaskBank, key: jax.Array, opts: ResetOptions,
          max_trial: int = -1, augment: bool = False) -> EnvState:
    """Fresh state for one env: pick (task, pair) and initialize.

    ``augment`` applies the meta-RL reset-time augmentation (random rot90 +
    color permutation, agents/env.py:31-42) to the chosen pair.
    """
    kp, ks, ka = jax.random.split(key, 3)
    prob = jnp.where(
        opts.prob_index >= 0, opts.prob_index,
        jax.random.randint(kp, (), 0, bank.n_tasks))
    count = bank.pair_count(prob, opts.adaptation)
    sub = jnp.where(
        opts.subprob_index >= 0, opts.subprob_index,
        jax.random.randint(ks, (), 0, jnp.maximum(count, 1)))
    flat = bank.pair_index(prob, sub, opts.adaptation)
    grid, dim = bank.in_grids[flat], bank.in_dims[flat]
    answer, answer_dim = bank.out_grids[flat], bank.out_dims[flat]
    if augment:
        from .augment import augment_task
        grid, dim, answer, answer_dim = augment_task(
            ka, grid, dim, answer, answer_dim)
    st = init_state(
        grid, dim, answer, answer_dim,
        max_trial=jnp.asarray(max_trial, I8),
        reset_on_submit=opts.reset_on_submit.astype(I8),
    )
    return st


step = _step
transition = _transition


# ---------------------------------------------------------------------------
# Batched lockstep engine
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ResetPool:
    """Pre-drawn fresh episodes for in-scan auto-reset.

    Reset-time augmentation (rot90 + recolor, agents/env.py:31-42) costs
    ~45 small kernels; executed inside the step's auto-reset branch it
    dominates the whole training rollout (~3.6 of ~6 ms/step at B=4096,
    launch-overhead-bound).  Drawing K fresh (task, pair, augmentation)
    triples per env slot *once per rollout* — where the same kernels run
    over [B*K] rows, bandwidth-bound — turns the in-scan reset into a
    plain row gather.

    Entry layout: env slot ``i`` owns rows ``[i*K, (i+1)*K)`` — drawn with
    slot ``i``'s own ResetOptions, so per-env task pinning (E-MAML) is
    preserved.  ``counter`` walks each slot's segment; consumption past K
    wraps (a rollout whose episodes are shorter than T/K steps re-uses
    augmentations — refresh more often or raise K if that matters).
    """

    grid: jax.Array        # i8 [B*K, H, W] input masked to dims (grid0)
    dim: jax.Array         # i8 [B*K, 2]
    answer: jax.Array      # i8 [B*K, H, W]
    answer_dim: jax.Array  # i8 [B*K, 2]
    counter: jax.Array     # i32 [B] next entry per env slot

    @property
    def k(self) -> int:
        return self.grid.shape[0] // self.counter.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatchedState:
    """Carry for a batch of envs stepping in lockstep: env states + per-env
    PRNG keys (for auto-reset task sampling) + optional reset pool."""

    env: EnvState              # leaves have leading [B]
    key: jax.Array             # u32 [B, 2]
    pool: Optional[ResetPool] = None

    @property
    def batch(self) -> int:
        return self.key.shape[0]


@dataclasses.dataclass(frozen=True)
class BatchedEnv:
    """Vectorized env family over a task bank.

    The reference has no in-env auto-reset (episode boundaries are the
    Gymnasium caller's job); a lockstep batch needs one, so ``auto_reset``
    replaces terminated/truncated envs with freshly sampled tasks, matching
    the reference's semantics *within* an episode exactly.  ``episode_limit``
    reproduces the TimeLimit wrapper the reference drivers use
    (train.py:67: TimeLimit(100), agents/wrapper.py:64: 300).

    BatchedEnv is itself a pytree (bank/opts are data leaves; the op table
    and scalars are static metadata), so pass it *as an argument* through
    ``jax.jit`` boundaries::

        step = jax.jit(BatchedEnv.step)
        bs, obs, rew, term, trunc = step(env, bs, action)

    Passed as an argument, the bank stays a device buffer; closed over,
    it would be baked into the compiled program as a constant.
    """

    table: OpTable
    bank: TaskBank
    max_trial: int = -1
    episode_limit: int = 0          # 0 = unlimited
    auto_reset: bool = True
    dense_reward: bool = False      # CustomO2ARCEnv shaping (env.py:44-58)
    pixel_reward: bool = False      # paper §4.1 reward: -(incorrect/total)
                                    # in [-1,0] (benchmarks/answer_given.py)
    terminate_on_match: bool = False  # paper §4.1 success: terminate when
                                    # the grid equals the answer (no Submit)
    augment: bool = False           # reset-time rot90+recolor (env.py:31-42)
    reset_pool: int = 0             # K>0: auto-reset consumes a K-entry
                                    # pre-drawn ResetPool instead of
                                    # computing reset+augment in-scan
    opts: ResetOptions = dataclasses.field(
        default_factory=lambda: ResetOptions.make())

    def _opts_axes(self):
        """Per-env options: leaves with a leading axis are mapped (used by
        the meta-RL layer to pin one task per env shard), scalars broadcast."""
        return jax.tree.map(lambda x: 0 if jnp.ndim(x) > 0 else None,
                            self.opts)

    def reset(self, key: jax.Array, batch: int) -> BatchedState:
        keys = jax.random.split(key, batch + 2)
        env = jax.vmap(
            lambda k, o: reset(self.bank, k, o, self.max_trial,
                               self.augment),
            in_axes=(0, self._opts_axes()))(keys[2:], self.opts)
        pool = (make_reset_pool(self, keys[1], batch)
                if self.reset_pool > 0 and self.auto_reset else None)
        return BatchedState(env=env, key=jax.random.split(keys[0], batch),
                            pool=pool)

    def _fresh_from_pool(self, pool: ResetPool, env2: EnvState) -> EnvState:
        """The next pre-drawn fresh state per env slot — the pooled
        counterpart of the vmapped ``reset`` in the auto-reset branch."""
        B = pool.counter.shape[0]
        idx = (jnp.arange(B, dtype=I32) * pool.k) + (pool.counter % pool.k)
        grid0, dim = pool.grid[idx], pool.dim[idx]
        zg = jnp.zeros_like(env2.grid)
        zd = jnp.zeros_like(env2.grid_dim)
        zs = jnp.zeros_like(env2.active)
        ros = jnp.broadcast_to(
            self.opts.reset_on_submit.astype(I8), (B,))
        return EnvState(
            trials_remain=jnp.full((B,), self.max_trial, I8),
            terminated=zs,
            input=grid0, input_dim=dim, grid=grid0, grid_dim=dim,
            clip=zg, clip_dim=zd, selected=zg, active=zs,
            object=zg, object_sel=zg, object_dim=zd, object_pos=zd,
            background=zg, rotation_parity=zs,
            answer=pool.answer[idx], answer_dim=pool.answer_dim[idx],
            reset_on_submit=ros,
            steps=jnp.zeros((B,), I32), submit_count=jnp.zeros((B,), I32),
            last_action_op=jnp.full((B,), -1, I32),
            last_reward=jnp.zeros((B,), jnp.float32),
        )

    def step(self, bs: BatchedState, action: Action
             ) -> Tuple[BatchedState, EnvState, jax.Array, jax.Array, jax.Array]:
        """Lockstep step.  Returns (carry, obs_states, reward, terminated,
        truncated); obs_states is the post-step pre-reset state pytree (what
        the agent observes, as Gymnasium returns the final observation
        before auto-reset).

        The two expensive rare paths — flood-fill fixpoint completion and
        auto-reset — run behind scalar ``lax.cond``s over the whole batch,
        so the per-step graph stays a single fused pass in the common case.
        """
        with jax.named_scope("transition"):
            env2, reward, term, pending = jax.vmap(
                _step_deferred, in_axes=(0, 0, None))(bs.env, action,
                                                      self.table)

        def flood_fixup(args):
            env2, action = args
            fixed = jax.vmap(_finish_flood, in_axes=(0, 0, None, 0))(
                env2, action, self.table, pending)
            return fixed

        with jax.named_scope("flood_fixup"):
            env2 = jax.lax.cond(
                jnp.any(pending), flood_fixup, lambda a: a[0],
                (env2, action))

        with jax.named_scope("reward"):
            env2, reward, term = self._shape_reward_term(env2, reward, term)

        if self.episode_limit > 0:
            trunc = env2.steps >= self.episode_limit
        else:
            trunc = jnp.zeros_like(term)
        if not self.auto_reset:
            return (BatchedState(env=env2, key=bs.key, pool=bs.pool),
                    env2, reward, term, trunc)
        with jax.named_scope("auto_reset"):
            bs3 = self._auto_reset(env2, bs, term | trunc)
        return bs3, env2, reward, term, trunc

    def _shape_reward_term(self, env2: EnvState, reward: jax.Array,
                           term: jax.Array):
        """Optional reward shaping / success-termination modes, applied to
        the post-op (pre-reset) state."""
        W = int(self.bank.in_grids.shape[-1])
        if self.dense_reward:
            from ..ops.table import dense_reward as _dense
            reward = jax.vmap(_dense)(env2, reward)
        if self.pixel_reward:
            from ..ops.table import pixel_reward as _pixel
            reward = jax.vmap(_pixel, in_axes=(0, None))(env2, W)
        if self.terminate_on_match:
            from ..ops.table import answers_match_any as _match
            solved = jax.vmap(_match, in_axes=(0, None))(env2, W)
            env2 = env2.replace(
                terminated=jnp.maximum(env2.terminated, solved.astype(I8)))
            term = env2.terminated != 0
        return env2, reward, term

    def _auto_reset(self, env2: EnvState, bs: BatchedState,
                    done: jax.Array) -> BatchedState:
        """Replace done envs with fresh states — from the pre-drawn pool
        when one rides the carry, else by computing reset+augment in-branch.
        Runs behind a batch-level ``lax.cond`` either way."""
        def merge(env2, fresh):
            return jax.tree.map(
                lambda a, b: jnp.where(
                    done.reshape((-1,) + (1,) * (a.ndim - 1)), b, a),
                env2, fresh)

        if bs.pool is not None:
            pool = bs.pool

            def do_reset(args):
                env2, ctr = args
                fresh = self._fresh_from_pool(
                    dataclasses.replace(pool, counter=ctr), env2)
                return merge(env2, fresh), ctr + done.astype(I32)

            env3, ctr2 = jax.lax.cond(
                jnp.any(done), do_reset, lambda a: a, (env2, pool.counter))
            return BatchedState(env=env3, key=bs.key,
                                pool=dataclasses.replace(pool, counter=ctr2))

        def do_reset(args):
            env2, keys = args
            split = jax.vmap(jax.random.split)(keys)   # [B, 2, 2]
            next_key, reset_key = split[:, 0], split[:, 1]
            fresh = jax.vmap(lambda k, b, o: reset(b, k, o, self.max_trial,
                                                   self.augment),
                             in_axes=(0, None, self._opts_axes()))(
                reset_key, self.bank, self.opts)
            env3 = merge(env2, fresh)
            # raw uint32 [B,2] keys need the trailing axis broadcast;
            # typed key arrays are logically [B]
            kmask = done if next_key.ndim == 1 else done[:, None]
            key3 = jnp.where(kmask, next_key, keys)
            return env3, key3

        env3, key3 = jax.lax.cond(
            jnp.any(done), do_reset, lambda a: a, (env2, bs.key))
        return BatchedState(env=env3, key=key3)


jax.tree_util.register_dataclass(
    BatchedEnv,
    data_fields=["bank", "opts"],
    meta_fields=["table", "max_trial", "episode_limit", "auto_reset",
                 "dense_reward", "pixel_reward", "terminate_on_match",
                 "augment", "reset_pool"],
)


def make_reset_pool(env: BatchedEnv, key: jax.Array, batch: int,
                    k: Optional[int] = None) -> ResetPool:
    """Draw ``k`` fresh (task, pair, augmentation) triples per env slot in
    one bandwidth-bound batch (see :class:`ResetPool`).  Slot ``i``'s
    entries use its own per-env ResetOptions row, so task pinning holds."""
    k = env.reset_pool if k is None else k
    keys = jax.random.split(key, batch * k)
    # tile per-env option rows K times so row i*K+j carries slot i's opts
    opts = jax.tree.map(
        lambda x: jnp.repeat(x, k, axis=0) if jnp.ndim(x) > 0 else x,
        env.opts)
    fresh = jax.vmap(
        lambda kk, o: reset(env.bank, kk, o, env.max_trial, env.augment),
        in_axes=(0, env._opts_axes()))(keys, opts)
    # only 4 leaves are kept — XLA dead-code-eliminates the rest
    return ResetPool(grid=fresh.grid, dim=fresh.grid_dim,
                     answer=fresh.answer, answer_dim=fresh.answer_dim,
                     counter=jnp.zeros((batch,), I32))


def flatten_grids(tree, H: int = 30, W: int = 30):
    """Reshape every [..., H, W] leaf to [..., H*W].

    The rollout scans carry grids in this flat form and restore the square
    form around each step (:func:`unflatten_grids`); the layout is kept
    until a measurement on the GPU shows whether it still pays."""
    return jax.tree.map(
        lambda x: x.reshape(*x.shape[:-2], H * W)
        if hasattr(x, "ndim") and x.ndim >= 2 and x.shape[-2:] == (H, W)
        else x, tree)


def unflatten_grids(tree, H: int = 30, W: int = 30):
    return jax.tree.map(
        lambda x: x.reshape(*x.shape[:-1], H, W)
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[-1] == H * W
        else x, tree)

# jit-friendly free-function aliases: the env rides along as a pytree arg.
batched_reset = BatchedEnv.reset
batched_step = BatchedEnv.step

# The jitted whole-batch reset.  Eager `env.reset` dispatches ~20 small
# kernels one by one; compiled it is one fused gather+init pass.  Drivers
# that reset per meta-iteration (E-MAML task re-pinning, continual phase
# switches) use this.  The env is a pytree argument; only a new
# (batch, bank shape, flag set) recompiles.
reset_jit = jax.jit(batched_reset, static_argnums=2)
