"""Action/observation wrappers: pure functions for the batched engine, and
Gymnasium classes for the compat layer (:mod:`.gym_wrappers`).

Counterparts of /root/reference/arcle/wrappers/bbox.py:9-49 (BBoxWrapper,
PointWrapper), agents/wrapper.py (max_grid_size variants, O2ARCNoFillEnv
registration) and agents/env.py:89-126 (FilterO2ARC).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import jax
import jax.numpy as jnp

from ..core.geometry import bbox_selection, point_selection
from ..core.state import Action, EnvState, I32


# ---------------------------------------------------------------------------
# Functional action builders (for the batched/jit path)
# ---------------------------------------------------------------------------
def bbox_action(x1, y1, x2, y2, op, H: int = 30, W: int = 30) -> Action:
    """(x1,y1,x2,y2,op) -> selection-mask action (bbox.py:22-30)."""
    return Action(selection=bbox_selection(x1, y1, x2, y2, H, W),
                  operation=jnp.asarray(op, I32))


def point_action(x, y, op, H: int = 30, W: int = 30) -> Action:
    """(x,y,op) -> one-pixel action (bbox.py:43-49)."""
    return Action(selection=point_selection(x, y, H, W),
                  operation=jnp.asarray(op, I32))


batched_bbox_action = jax.vmap(bbox_action, in_axes=(0, 0, 0, 0, 0, None, None))
batched_point_action = jax.vmap(point_action, in_axes=(0, 0, 0, None, None))


# The 9-key observation projection of FilterO2ARC (agents/env.py:109-126).
FILTER_O2ARC_KEYS = ("trials_remain", "grid", "grid_dim", "clip", "clip_dim",
                     "active", "object", "object_dim", "object_pos")


def filter_obs(state: EnvState) -> Dict[str, jax.Array]:
    """Project a (possibly batched) EnvState to the FilterO2ARC key set."""
    return OrderedDict(
        (k, getattr(state, k)) for k in FILTER_O2ARC_KEYS)


def flatten_obs(state: EnvState) -> jax.Array:
    """FilterO2ARC + FlattenObservation as one pure function: concatenation
    in alphabetical key order, matching Gymnasium's Dict flattening (the
    order GPTPolicy.unflatten_vec hard-codes, GPTPolicy.py:17-42)."""
    flat = []
    for k in sorted(FILTER_O2ARC_KEYS):
        v = getattr(state, k)
        if k in ("grid", "clip", "object"):          # [..., H, W] -> [..., H*W]
            if v.shape[-2:] == (30, 30):             # square layout
                v = v.reshape(*v.shape[:-2], -1)
            flat.append(v)                           # flat layout: as-is
        elif k in ("grid_dim", "clip_dim", "object_dim", "object_pos"):
            flat.append(v)                            # [..., 2]
        else:                                         # scalars -> [..., 1]
            flat.append(v[..., None])
    # int8 keeps rollout storage/traffic 4x smaller; every field fits the
    # int8 range by the observation-space contract. Models cast on entry.
    return jnp.concatenate([f.astype(jnp.int8) for f in flat], axis=-1)


# Full 16-field flattening in the reference's FlattenObservation order
# (GPTPolicy.unflatten_vec hard-codes it, GPTPolicy.py:17-42): Dict keys
# alphabetical with object_states nested between input_dim and selected.
FULL_OBS_FIELDS = (
    ("clip", 900), ("clip_dim", 2), ("grid", 900), ("grid_dim", 2),
    ("input", 900), ("input_dim", 2), ("active", 1), ("background", 900),
    ("object", 900), ("object_dim", 2), ("object_pos", 2),
    ("object_sel", 900), ("rotation_parity", 1), ("selected", 900),
    ("terminated", 1), ("trials_remain", 1),
)
FULL_OBS_DIM = sum(n for _, n in FULL_OBS_FIELDS)   # 6314


def full_flatten_obs(state: EnvState) -> jax.Array:
    """Full observation vector (the GPT training path, which does not use
    FilterO2ARC — train_gpt.py feeds the complete flattened dict)."""
    flat = []
    for k, n in FULL_OBS_FIELDS:
        v = getattr(state, k)
        if n == 900:
            if v.shape[-2:] == (30, 30):
                v = v.reshape(*v.shape[:-2], -1)
            flat.append(v)
        elif n == 2:
            flat.append(v)
        else:
            flat.append(v[..., None])
    return jnp.concatenate([f.astype(jnp.int8) for f in flat], axis=-1)


def unflatten_full(obs: jax.Array, H: int = 30, W: int = 30):
    """Inverse of :func:`full_flatten_obs` -> dict of int arrays
    (GPTPolicy.unflatten_vec counterpart)."""
    out = {}
    ofs = 0
    for k, n in FULL_OBS_FIELDS:
        v = obs[..., ofs:ofs + n]
        ofs += n
        if n == 900:
            v = v.reshape(*v.shape[:-1], H, W)
        elif n == 1:
            v = v.squeeze(-1)
        out[k] = v.astype(jnp.int32)
    return out


_GYM_CLASSES = ("BBoxWrapper", "PointWrapper", "FilterO2ARC")


def __getattr__(name):
    # the Gymnasium wrapper classes need the ``gym`` extra; import them on
    # first use so the batched path runs without gymnasium
    if name in _GYM_CLASSES:
        from . import gym_wrappers
        return getattr(gym_wrappers, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "bbox_action", "point_action", "batched_bbox_action",
    "batched_point_action", "filter_obs", "flatten_obs",
    "full_flatten_obs", "unflatten_full", "FULL_OBS_DIM",
    "FILTER_O2ARC_KEYS", "BBoxWrapper", "PointWrapper", "FilterO2ARC",
]
