"""Autoregressive (operation, bbox) action distribution.

Counterpart of the reference ``AROPandBBox``
(/root/reference/agents/models/bboxdist.py:20-66): a Categorical over the
operation from per-op tokens, then a TruncatedNormal over the 4 bbox
coordinates conditioned on the *chosen* op's head output
(mu = sigmoid(head), sigma = exp(clamp(head, -20, 2)), support [0, 1]);
coordinates are scaled by the grid size and floored to ints, and ``log_prob``
recomputes both terms from stored integer actions (bboxdist.py:51-60).

Batched formulation: the bbox heads are applied to *all* op tokens up
front (one batched matmul, ``bbox_mean_all``/``bbox_std_all`` in
GPTPolicy's output) and the chosen op's row is selected with one-hot
arithmetic — a compare+einsum that fuses into the surrounding pass in
place of a batched 1-element gather.

This module is the single source of truth for the distribution math; the
training agents (training/agents.py) call these functions directly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .truncated_normal import TruncatedNormal

MIN_LOG_STD, MAX_LOG_STD = -20.0, 2.0


class OpBBoxSample(NamedTuple):
    operation: jax.Array   # i32 [...]
    bbox: jax.Array        # i32 [..., 4]  (x1, y1, x2, y2)
    log_prob: jax.Array    # f32 [...]


def select_op(per_op: jax.Array, operation: jax.Array) -> jax.Array:
    """Select ``per_op[..., operation, :]`` -> [..., D] without a gather:
    one-hot compare + einsum."""
    n = per_op.shape[-2]
    classes = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    oh = (operation[..., None] == classes).astype(per_op.dtype)
    return jnp.einsum("...o,...od->...d", oh, per_op)


def op_log_softmax_at(op_logits: jax.Array, operation: jax.Array) -> jax.Array:
    """log softmax(op_logits)[operation] via one-hot arithmetic."""
    ls = jax.nn.log_softmax(op_logits, axis=-1)
    n = ls.shape[-1]
    classes = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    oh = (operation[..., None] == classes).astype(ls.dtype)
    return jnp.sum(ls * oh, axis=-1)


def make_dist(mean_all: jax.Array, std_all: jax.Array,
              operation: jax.Array,
              min_log_std: float = MIN_LOG_STD) -> TruncatedNormal:
    """TruncatedNormal over [0,1]^4 conditioned on the chosen op's head
    outputs (mean_all/std_all: [..., n_ops, 4] raw head values).

    ``min_log_std`` defaults to the reference's -20 (bboxdist.py:37 —
    the std may collapse to ~0); RL drivers that need sustained
    exploration can raise it to put a floor under the bbox noise (the
    answer-given benchmark uses -2.3 ≈ std 0.1)."""
    mean = jax.nn.sigmoid(select_op(mean_all, operation))
    std = jnp.exp(jnp.clip(select_op(std_all, operation),
                           min_log_std, MAX_LOG_STD))
    return TruncatedNormal.create(mean, std, 0.0, 1.0)


def sample(key: jax.Array, op_logits: jax.Array, mean_all: jax.Array,
           std_all: jax.Array, grid_size: int = 30,
           deterministic: bool = False,
           min_log_std: float = MIN_LOG_STD,
           quantized_log_prob: bool = False) -> OpBBoxSample:
    """op ~ Categorical(logits); bbox ~ TruncNorm(head(op)) * size, floored
    (bboxdist.py:29-49).  ``deterministic`` takes argmax op + distribution
    mean (the explore=False post-adaptation path).

    ``quantized_log_prob=False`` evaluates the stored log-prob at the
    *continuous* sample, exactly like the reference (bboxdist.py:38) —
    which means a later ``log_prob`` recomputation from the stored
    integer action differs even with unchanged params.  True evaluates
    at the discretized value instead, so behavior/current ratios start
    at exactly 1 (used by the answer-given benchmark learner)."""
    k_op, k_bb = jax.random.split(key)
    if deterministic:
        operation = jnp.argmax(op_logits, axis=-1)
    else:
        operation = jax.random.categorical(k_op, op_logits, axis=-1)
    lp_op = op_log_softmax_at(op_logits, operation)
    dist = make_dist(mean_all, std_all, operation, min_log_std)
    u = dist.mean() if deterministic else dist.sample(k_bb)
    u = jnp.clip(u, 0.0, 1.0)
    bbox = jnp.clip(jnp.floor(u * grid_size), 0,
                    grid_size - 1).astype(jnp.int32)
    u_eval = bbox.astype(jnp.float32) / grid_size if quantized_log_prob \
        else u
    lp = lp_op + dist.log_prob(u_eval).sum(-1)
    return OpBBoxSample(operation.astype(jnp.int32), bbox, lp)


def log_prob(op_logits: jax.Array, mean_all: jax.Array, std_all: jax.Array,
             operation: jax.Array, bbox: jax.Array,
             grid_size: int = 30,
             min_log_std: float = MIN_LOG_STD) -> jax.Array:
    """Recompute log p(op, bbox) for stored integer actions
    (bboxdist.py:51-60: continuous value taken as bbox/size)."""
    lp_op = op_log_softmax_at(op_logits, operation)
    dist = make_dist(mean_all, std_all, operation, min_log_std)
    u = bbox.astype(jnp.float32) / grid_size
    return lp_op + dist.log_prob(u).sum(-1)


def entropy(op_logits: jax.Array, mean_all: jax.Array, std_all: jax.Array,
            operation: jax.Array,
            min_log_std: float = MIN_LOG_STD) -> jax.Array:
    p = jax.nn.softmax(op_logits, axis=-1)
    ent_op = -jnp.sum(p * jax.nn.log_softmax(op_logits, axis=-1), axis=-1)
    dist = make_dist(mean_all, std_all, operation, min_log_std)
    return ent_op + dist.entropy().sum(-1)


# ---------------------------------------------------------------------------
# Discrete selection head (categorical per bbox coordinate)
#
# For small grids (the §4.1 answer-given benchmark at 5x5) a categorical
# over the grid_size bins per coordinate is the batched selection head:
# exact log-probs/entropy, no quantization mismatch, and exploration that
# sharpens without collapsing below the entropy bonus.  Same autoregressive
# structure as AROPandBBox: op ~ Categorical, then the chosen op token's
# coordinate logits.
# ---------------------------------------------------------------------------
def _select_op_logits(bbox_logits_all: jax.Array,
                      operation: jax.Array) -> jax.Array:
    """bbox_logits_all [..., n_ops, 4, bins] -> chosen op's [..., 4, bins]
    via the same one-hot contraction as :func:`select_op`."""
    *lead, n, four, bins = bbox_logits_all.shape
    flat = bbox_logits_all.reshape(*lead, n, four * bins)
    return select_op(flat, operation).reshape(*lead, four, bins)


def sample_categorical(key: jax.Array, op_logits: jax.Array,
                       bbox_logits_all: jax.Array,
                       deterministic: bool = False) -> OpBBoxSample:
    k_op, k_bb = jax.random.split(key)
    if deterministic:
        operation = jnp.argmax(op_logits, axis=-1)
    else:
        operation = jax.random.categorical(k_op, op_logits, axis=-1)
    lp_op = op_log_softmax_at(op_logits, operation)
    bl = _select_op_logits(bbox_logits_all, operation)    # [..., 4, bins]
    if deterministic:
        coords = jnp.argmax(bl, axis=-1)
    else:
        coords = jax.random.categorical(k_bb, bl, axis=-1)
    ls = jax.nn.log_softmax(bl, axis=-1)
    classes = jax.lax.broadcasted_iota(jnp.int32, (ls.shape[-1],), 0)
    lp_bb = jnp.sum(ls * (coords[..., None] == classes).astype(ls.dtype),
                    axis=-1)
    return OpBBoxSample(operation.astype(jnp.int32),
                        coords.astype(jnp.int32),
                        lp_op + lp_bb.sum(-1))


def log_prob_categorical(op_logits: jax.Array, bbox_logits_all: jax.Array,
                         operation: jax.Array,
                         bbox: jax.Array) -> jax.Array:
    lp_op = op_log_softmax_at(op_logits, operation)
    bl = _select_op_logits(bbox_logits_all, operation)
    ls = jax.nn.log_softmax(bl, axis=-1)
    bins = ls.shape[-1]
    classes = jax.lax.broadcasted_iota(jnp.int32, (bins,), 0)
    oh = (bbox[..., None] == classes).astype(ls.dtype)
    lp_bb = jnp.sum(ls * oh, axis=-1)
    return lp_op + lp_bb.sum(-1)


def entropy_categorical(op_logits: jax.Array, bbox_logits_all: jax.Array,
                        operation: jax.Array) -> jax.Array:
    p = jax.nn.softmax(op_logits, axis=-1)
    ent_op = -jnp.sum(p * jax.nn.log_softmax(op_logits, axis=-1), axis=-1)
    bl = _select_op_logits(bbox_logits_all, operation)
    pb = jax.nn.softmax(bl, axis=-1)
    ent_bb = -jnp.sum(pb * jax.nn.log_softmax(bl, axis=-1), axis=-1)
    return ent_op + ent_bb.sum(-1)
