"""Paper §4.1 benchmark: "Solving ARC with a given answer".

The reference's headline published result (arcle_paper.pdf §4.1.1, the
first row of BASELINE.md) is produced in this setting:

* operations ``Color0..Color{k-1}`` only, selection as a bounding box;
* the state sufficient for decision making is
  ``(grid, grid_dim, answer, answer_dim)`` — the answer is *given*;
* dense reward ``r = -(incorrect pixels) / (total pixels)`` in [-1, 0]
  ("a dense reward function that penalizes the agent by the ratio of
  incorrect pixels of the next state", §4.1);
* the episode succeeds (terminates) when the grid equals the answer;
* two task distributions: (1) the **random setting** — uniformly random
  5x5 initial grid and goal — and (2) the **ARC setting** — initial grids
  and goals at most 5x5 drawn from ARC-like tasks;
* PPO with three auxiliary losses (L_{r_{t-1}}, L_{r_t}, L_{s_{t+1}}) and
  the color-equivariant non-factorized policy of §4.1.2.  With all three
  aux losses the paper reports 3-of-4 agents >95% success in the random
  setting; vanilla PPO learns nothing.

This module supplies the setting; the policy is the existing
:class:`~arcle_tpu.models.gpt.GPTPolicy` (which already implements the
paper's color-equivariant operation tokens, per-op-token logits,
op-conditioned bbox heads, and the action-conditioned second pass for the
state-action aux features) configured at 5x5 with color ops only.  The
driver is :mod:`arcle_tpu.training.train_answer_given`.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.state import EnvState
from ..envs.core import BatchedEnv, ResetOptions
from ..loaders.loader import Loader, TaskTuple
from ..loaders.synthetic import make_tasks
from ..models import bbox_dist
from ..models.gpt_config import GPTConfig
from ..ops.groups import G
from ..ops.table import OpTable, exact_ratio
from ..training.agents import Agent

if TYPE_CHECKING:   # the transformer needs flax; the env does not
    from ..models.gpt import GPTPolicy


# ---------------------------------------------------------------------------
# Task distributions
# ---------------------------------------------------------------------------
class RandomPairLoader(Loader):
    """The paper's **random setting**: each task is one (initial grid,
    goal) pair of independent uniformly random ``h x w`` grids over
    ``colors`` colors (§4.1: "randomly generated 5x5 initial grid and
    goal").  A large ``n_tasks`` stands in for the paper's per-episode
    resampling; with the default 16k tasks an agent sees a fresh pair
    essentially every episode."""

    def __init__(self, n_tasks: int = 16384, h: int = 5, w: int = 5,
                 colors: int = 10, seed: int = 0):
        self._n = n_tasks
        self._h, self._w = h, w
        self._colors = colors
        self._seed = seed
        super().__init__()

    def get_path(self, **kw) -> List[str]:
        return ["<random>"] * self._n

    def parse(self, **kw) -> List[TaskTuple]:
        rng = np.random.default_rng(self._seed)
        out = []
        for k in range(self._n):
            g = rng.integers(0, self._colors,
                             (self._h, self._w)).astype(np.int8)
            a = rng.integers(0, self._colors,
                             (self._h, self._w)).astype(np.int8)
            out.append(([g], [a], [g.copy()], [a.copy()],
                        {"id": f"rand{k:06d}"}))
        return out


def small_arc_loader(n_tasks: int = 512, max_size: int = 5,
                     colors: int = 10, seed: int = 0) -> Loader:
    """The paper's **ARC setting**: initial grids and goals at most 5x5
    from ARC tasks (§4.1).  The real corpus is absent from this mount
    (SURVEY §2.1 #1), so ARC-like synthetic tasks stand in — same
    structural envelope (consistent hidden rule per task, dims <= 5).

    Only shape-preserving pairs are kept: with Color ops alone the grid
    dims can never change, so a pair whose answer dims differ from its
    input dims is unsolvable in this setting (the paper can only have
    used such tasks)."""
    from ..loaders.loader import ListLoader
    from ..loaders.synthetic import make_tasks
    kept: List[TaskTuple] = []
    batch_seed = seed
    while len(kept) < n_tasks:
        for t in make_tasks(n_tasks, seed=batch_seed, min_size=2,
                            max_size=max_size, n_train=2, n_test=1,
                            colors=colors):
            ti, to, ei, eo, d = t
            if all(i.shape == o.shape
                   for i, o in zip(ti + ei, to + eo)):
                kept.append(t)
                if len(kept) >= n_tasks:
                    break
        batch_seed += 1000003
    return ListLoader(kept)


# ---------------------------------------------------------------------------
# Op table and environment
# ---------------------------------------------------------------------------
def color_table(n_colors: int = 10) -> OpTable:
    """Color0..Color{k-1} only — "we use operations of 0-9 only"
    (§4.1).  No Submit: success is checked against the answer after every
    step (``terminate_on_match``)."""
    return OpTable(
        name=f"AnswerGiven{n_colors}",
        group=tuple([G.COLOR] * n_colors),
        param=tuple(range(n_colors)),
        reset_sel=tuple([False] * n_colors),
        max_trial=-1,
        submit_op=-1,
    )


def answer_given_env(n_tasks: int = 16384, h: int = 5, w: int = 5,
                     colors: int = 10, seed: int = 0,
                     episode_limit: int = 50,
                     setting: str = "random",
                     loader: Optional[Loader] = None) -> BatchedEnv:
    """Batched lockstep env for the §4.1 setting.

    ``setting``: "random" (uniform grids) or "arc" (ARC-like tasks <=5x5).
    """
    if loader is None:
        if setting == "random":
            loader = RandomPairLoader(n_tasks, h, w, colors, seed)
        elif setting == "arc":
            loader = small_arc_loader(min(n_tasks, 1024), max(h, w),
                                      colors, seed)
        else:
            raise ValueError(setting)
    bank = loader.bank(H=h, W=w)
    return BatchedEnv(
        table=color_table(colors), bank=bank, max_trial=-1,
        episode_limit=episode_limit, auto_reset=True,
        pixel_reward=True, terminate_on_match=True,
        opts=ResetOptions.make(adaptation=True),
    )


# ---------------------------------------------------------------------------
# Observation + agent
# ---------------------------------------------------------------------------
def answer_obs(state: EnvState) -> jax.Array:
    """Flat f32 ``[B, h*w + 2 + h*w + 2]`` observation: the paper's
    sufficient state (grid, grid_dim, answer, answer_dim), grid cells
    first (the aux L_{s_{t+1}} target slice is ``[0, h*w)``)."""
    B = state.grid.shape[0]
    return jnp.concatenate([
        state.grid.reshape(B, -1).astype(jnp.float32),
        state.grid_dim.astype(jnp.float32),
        state.answer.reshape(B, -1).astype(jnp.float32),
        state.answer_dim.astype(jnp.float32),
    ], axis=-1)


def shaping_potential(obs: jax.Array, h: int, w: int) -> jax.Array:
    """phi(s) = -(wrong cells inside ``answer_dim``)/(answer area) read
    straight off the flat answer-given observation (any leading batch
    dims).  Computed like :func:`arcle_tpu.ops.table.pixel_reward`, in
    integers and :func:`~arcle_tpu.ops.table.exact_ratio`, it equals that
    reward of the same state bit for bit on every backend, so the
    driver's potential-based shaping (phi(s_{t+1}) == r_t) is exactly
    policy-invariant in the ARC setting too, where dims can be smaller
    than ``h x w``."""
    P = h * w
    g = obs[..., :P]
    a = obs[..., P + 2:2 * P + 2]
    ad = obs[..., 2 * P + 2:2 * P + 4].astype(jnp.int32)
    idx = jnp.arange(P, dtype=jnp.int32)
    inside = (idx // w < ad[..., :1]) & (idx % w < ad[..., 1:2])
    wrong = jnp.where(inside, g != a, False).sum(-1).astype(jnp.int32)
    return -exact_ratio(wrong, ad[..., 0] * ad[..., 1])


def _unpack(obs: jax.Array, h: int, w: int):
    p = h * w
    grid = obs[..., :p].astype(jnp.int8).reshape(*obs.shape[:-1], h, w)
    grid_dim = obs[..., p:p + 2].astype(jnp.int8)
    ans = obs[..., p + 2:2 * p + 2].astype(jnp.int8).reshape(
        *obs.shape[:-1], h, w)
    ans_dim = obs[..., 2 * p + 2:2 * p + 4].astype(jnp.int8)
    return grid, grid_dim, ans, ans_dim


def make_policy(h: int = 5, w: int = 5, colors: int = 10,
                n_layer: int = 4, n_head: int = 4, n_embd: int = 128,
                factorized: bool = False,
                color_equivariant: bool = True,
                bbox_dist_kind: str = "categorical") -> GPTPolicy:
    """The §4.1.2 policy family at benchmark scale.

    ``color_equivariant=True`` (default) is the paper's color-equivariant
    architecture: color-op tokens are pure functions of the color
    embedding.  ``factorized=True`` is the paper's *non-sequential*
    control: operation and selection from two independent special tokens
    (assumes operation ⫫ selection | s).  ``bbox_dist_kind``:
    "categorical" (default — a discrete per-coordinate selection head,
    exact log-probs on the small grid) or "truncnorm" (the reference
    AROPandBBox parameterization)."""
    cfg = GPTConfig(grid_x=h, grid_y=w, num_colors=colors,
                    num_actions=colors, n_layer=n_layer, n_head=n_head,
                    n_embd=n_embd, embd_pdrop=0.0, resid_pdrop=0.0,
                    attn_pdrop=0.0, remat=False,
                    factorized=factorized,
                    color_equivariant=color_equivariant,
                    bbox_bins=(max(h, w)
                               if bbox_dist_kind == "categorical" else 0))
    from ..models.gpt import GPTPolicy
    return GPTPolicy(cfg)


def answer_given_agent(model: GPTPolicy,
                       min_log_std: float = -2.3,
                       sequential: bool = False) -> Agent:
    """Agent over the (grid, answer) observation; the answer rides in the
    policy's second grid slot (the reference GPT feeds ``input`` there —
    here the sufficient state is the answer instead, §4.1).

    Two benchmark-local deviations from the reference distribution quirks
    (both documented in models/bbox_dist.py): a floor on the bbox std
    (``min_log_std`` = -2.3 ≈ std 0.1 on the [0,1] support — prevents
    irreversible exploration collapse; the reference allows exp(-20)) and
    quantized sampled log-probs (PPO ratios start at exactly 1)."""
    c = model.cfg
    h, w = c.grid_x, c.grid_y
    grid_size = max(h, w)

    def forward(params, obs, operation=None, bbox=None):
        grid, grid_dim, ans, ans_dim = _unpack(obs, h, w)
        B = grid.shape[0]
        z = jnp.zeros((B,), jnp.int8)
        return model.apply(params, grid, grid_dim, ans, ans_dim, z, z,
                           operation=operation, bbox=bbox)

    categorical = model.cfg.bbox_bins > 0

    def _sel_source(params, obs, op, out1):
        """Where the selection distribution reads from: the single
        unconditioned pass (non-sequential / color-equivariant — §4.1.2
        archs (1),(3)), or a second forward with the *sampled operation's*
        embedding token appended (§4.1.2 arch (2), "sequential policy...
        requires two forward passes"; the appended bbox token carries a
        constant 0, only the operation conditions this pass)."""
        if not sequential:
            return out1
        return forward(params, obs, operation=op.astype(jnp.int32),
                       bbox=jnp.zeros(op.shape + (4,), jnp.float32))

    def sample_fn(params, obs, key, deterministic=False):
        out = forward(params, obs)
        k_op, k_bb = jax.random.split(key)
        if deterministic:
            op = jnp.argmax(out["op_logits"], axis=-1)
        else:
            op = jax.random.categorical(k_op, out["op_logits"], axis=-1)
        lp_op = bbox_dist.op_log_softmax_at(out["op_logits"], op)
        src = _sel_source(params, obs, op, out)
        if categorical:
            bl = bbox_dist._select_op_logits(src["bbox_logits_all"], op)
            if deterministic:
                coords = jnp.argmax(bl, axis=-1)
            else:
                coords = jax.random.categorical(k_bb, bl, axis=-1)
            ls = jax.nn.log_softmax(bl, axis=-1)
            classes = jax.lax.broadcasted_iota(jnp.int32,
                                               (ls.shape[-1],), 0)
            lp_bb = jnp.sum(
                ls * (coords[..., None] == classes).astype(ls.dtype), -1
            ).sum(-1)
            bbox = coords.astype(jnp.int32)
        else:
            dist = bbox_dist.make_dist(src["bbox_mean_all"],
                                       src["bbox_std_all"], op,
                                       min_log_std)
            u = dist.mean() if deterministic else dist.sample(k_bb)
            u = jnp.clip(u, 0.0, 1.0)
            bbox = jnp.clip(jnp.floor(u * grid_size), 0,
                            grid_size - 1).astype(jnp.int32)
            lp_bb = dist.log_prob(
                bbox.astype(jnp.float32) / grid_size).sum(-1)
        acts = jnp.concatenate([bbox, op[..., None].astype(jnp.int32)], -1)
        return acts, lp_op + lp_bb, out["value"]

    def evaluate_fn(params, obs, actions):
        out = forward(params, obs)
        op = actions[..., 4]
        src = _sel_source(params, obs, op, out)
        if categorical:
            lp = bbox_dist.log_prob_categorical(
                out["op_logits"], src["bbox_logits_all"], op,
                actions[..., :4])
            ent = bbox_dist.entropy_categorical(
                out["op_logits"], src["bbox_logits_all"], op)
        else:
            lp = bbox_dist.log_prob(
                out["op_logits"], src["bbox_mean_all"],
                src["bbox_std_all"], op, actions[..., :4],
                grid_size, min_log_std=min_log_std)
            ent = bbox_dist.entropy(
                out["op_logits"], src["bbox_mean_all"],
                src["bbox_std_all"], op, min_log_std=min_log_std)
        return lp, out["value"], ent

    def aux_fn(params, obs, actions):
        """Action-conditioned second forward for L_{r_t} / L_{s_{t+1}}
        (§4.1.1: "forward propagation again with additional action
        embedding tokens"); r_{t-1} read from the same conditioned pass
        (documented one-pass simplification, see training/agents.py)."""
        out = forward(params, obs,
                      operation=actions[..., 4].astype(jnp.int32),
                      bbox=actions[..., :4].astype(jnp.float32) / grid_size)
        return {"rtm1": out["aux_rtm1"], "r": out["aux_reward"],
                "g_logits": out["aux_transition"]}

    def init_fn(key, obs):
        grid, grid_dim, ans, ans_dim = _unpack(obs, h, w)
        B = grid.shape[0]
        z = jnp.zeros((B,), jnp.int8)
        return model.init(key, grid, grid_dim, ans, ans_dim, z, z)

    return Agent(obs_fn=answer_obs, sample_fn=sample_fn,
                 evaluate_fn=evaluate_fn, init_fn=init_fn,
                 obs_dim=2 * h * w + 4, aux_fn=aux_fn)


@dataclasses.dataclass(frozen=True)
class AnswerGivenConfig:
    """One §4.1 experiment cell."""

    setting: str = "random"        # "random" | "arc"
    h: int = 5
    w: int = 5
    colors: int = 10
    n_tasks: int = 16384
    episode_limit: int = 50
    # policy (§4.1.2): color_eq | nonseq (factorized control) |
    # sequential (two-pass selection conditioned on the sampled op)
    arch: str = "color_eq"
    n_layer: int = 4
    n_head: int = 4
    n_embd: int = 128
    # aux losses (§4.1.1); subsets for the Figure-5 ablation
    aux: str = "all"               # "none" | "rtm1" | "rtm1+rt" | "all"
